"""Port vs JAX: the host data pipeline (data/, utils/imaging.py).

The two packages must hand the trainer the same batches bit for bit for
the same directories and seed: same files, same shuffle, same per-item
generators drawn in the same order by the same augmentations.  Every
comparison here is exact (np.array_equal).  The JAX side runs serially
(its own tests hold its thread and process backends equal to that); the
port runs each of its backends.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from deepinpainting_tpu.data import BatchIterator as JBatchIterator
from deepinpainting_tpu.data import InpaintDataset as JInpaintDataset
from deepinpainting_tpu.data.dataset import SelfRefDataset as JSelfRef
from deepinpainting_tpu.utils import imaging as jimaging
from deepinpainting_torch.data import (BatchIterator, InpaintDataset,
                                       SelfRefDataset, device_batches,
                                       prefetch)
from deepinpainting_torch.utils import imaging

REPO = Path(__file__).resolve().parent.parent
S = 48


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """7 images of mixed sizes and modes (one grayscale), 5 refs, 3 masks
    with soft edges, so resize, convert and mask binarisation all act."""
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    out = {}
    for name, n in (("img", 7), ("ref", 5), ("mask", 3)):
        d = root / name
        d.mkdir()
        for i in range(n):
            size = (S + 8 * i, S + 5 * (i % 3))
            if name == "mask":
                a = np.zeros(size[::-1] + (3,), np.uint8)
                a[10 + i:30, 12:34 + i] = 255
                a[9 + i, 12:34] = 90                  # a soft edge
                Image.fromarray(a).save(d / f"m{i}.png")
            elif name == "img" and i == 3:
                a = rng.integers(0, 256, size[::-1], dtype=np.uint8)
                Image.fromarray(a, "L").save(d / f"x{i}.png")
            else:
                a = rng.integers(0, 256, size[::-1] + (3,), dtype=np.uint8)
                Image.fromarray(a).save(d / f"x{i}.jpg")
        out[name] = str(d)
    return out


def _equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"image", "mask", "ref"}
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            assert np.array_equal(g[k], w[k]), k


@pytest.mark.parametrize("transport", ["uint8", "float32"])
@pytest.mark.parametrize("backend,workers", [
    pytest.param("process", 0, id="serial"),
    pytest.param("thread", 3, id="thread")])
def test_batches_equal_jax_bit_for_bit(dirs, transport, backend, workers):
    args = (dirs["img"], dirs["mask"], dirs["ref"], S)
    kw = dict(seed=5, transport=transport)
    ours = BatchIterator(InpaintDataset(*args, **kw), 2, seed=11,
                         workers=workers, backend=backend)
    theirs = JBatchIterator(JInpaintDataset(*args, **kw), 2, seed=11)
    _equal(ours, theirs)
    # a second epoch of the same iterator moves on in both
    _equal(ours, theirs)


def test_process_backend_equals_jax(dirs):
    args = (dirs["img"], dirs["mask"], dirs["ref"], S)
    ds = InpaintDataset(*args, seed=2)
    try:
        ours = list(BatchIterator(ds, 3, seed=4, workers=2,
                                  backend="process"))
    finally:
        ds.close()
    _equal(ours, JBatchIterator(JInpaintDataset(*args, seed=2), 3, seed=4))


def test_self_ref_dataset_equals_jax(dirs):
    ours = SelfRefDataset(dirs["img"], dirs["mask"], S)
    theirs = JSelfRef(dirs["img"], dirs["mask"], S)
    _equal(BatchIterator(ours, 2, shuffle=False, drop_last=False),
           JBatchIterator(theirs, 2, shuffle=False, drop_last=False))
    item = ours[1]
    assert np.array_equal(item["ref"], item["image"])
    assert set(np.unique(item["mask"])) <= {0, 1}
    # mask_per_index: image i takes mask i mod 3, whatever the generator
    assert np.array_equal(ours.fetch(4, np.random.default_rng(1))["mask"],
                          ours.fetch(1, np.random.default_rng(2))["mask"])


def test_drop_last_and_ragged_tail(dirs):
    ds = InpaintDataset(dirs["img"], dirs["mask"], dirs["ref"], S)
    full = BatchIterator(ds, 3, seed=0)
    assert len(full) == 2
    assert [b["image"].shape[0] for b in full] == [3, 3]
    ragged = BatchIterator(ds, 3, seed=0, drop_last=False)
    assert len(ragged) == 3
    assert [b["image"].shape[0] for b in ragged] == [3, 3, 1]
    _equal(BatchIterator(ds, 3, seed=0, drop_last=False),
           JBatchIterator(JInpaintDataset(dirs["img"], dirs["mask"],
                                          dirs["ref"], S),
                          3, seed=0, drop_last=False))


def test_rows_slice_the_global_stream(dirs):
    ds = InpaintDataset(dirs["img"], dirs["mask"], dirs["ref"], S)
    whole = list(BatchIterator(ds, 4, seed=3))
    part = list(BatchIterator(ds, 4, seed=3, rows=(1, 3)))
    assert len(part) == len(whole) == 1
    for k in whole[0]:
        assert np.array_equal(part[0][k], whole[0][k][1:3])
    with pytest.raises(ValueError, match="drop_last"):
        BatchIterator(ds, 4, rows=(0, 2), drop_last=False)


def test_prefetch_keeps_order_and_raises():
    assert list(prefetch(iter(range(10)), depth=2)) == list(range(10))

    def broken():
        yield 1
        raise KeyError("decode failed")

    it = prefetch(broken())
    assert next(it) == 1
    with pytest.raises(KeyError, match="decode failed"):
        next(it)


def test_device_batches_on_cpu(dirs):
    ds = InpaintDataset(dirs["img"], dirs["mask"], dirs["ref"], S)
    want = list(BatchIterator(ds, 2, seed=9))
    got = list(device_batches(iter(BatchIterator(ds, 2, seed=9)), "cpu"))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for k in w:
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            assert np.array_equal(g[k].numpy(), w[k])


def test_bad_inputs_are_refused(dirs, tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    for roots in ((empty, dirs["mask"], dirs["ref"]),
                  (dirs["img"], empty, dirs["ref"]),
                  (dirs["img"], dirs["mask"], empty)):
        with pytest.raises(FileNotFoundError):
            InpaintDataset(*map(str, roots), S)
    ds = InpaintDataset(dirs["img"], dirs["mask"], dirs["ref"], S)
    with pytest.raises(ValueError, match="batch_size"):
        BatchIterator(ds, 8)
    with pytest.raises(ValueError, match="transport"):
        InpaintDataset(dirs["img"], dirs["mask"], dirs["ref"], S,
                       transport="f16")
    with pytest.raises(ValueError, match="backend"):
        BatchIterator(ds, 2, backend="fiber")


def test_loader_workers_import_no_torch():
    """A spawned worker imports the dataset module and the package around
    it; neither may load torch (seconds of start-up a worker, and a CUDA
    runtime that a worker must never touch)."""
    code = ("import sys\n"
            "import deepinpainting_torch.data.dataset\n"
            "import deepinpainting_torch._cli\n"
            "sys.exit(1 if 'torch' in sys.modules else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={"PYTHONPATH": str(REPO), "PATH": ""},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_imaging_equals_jax(dirs, tmp_path):
    rng = np.random.default_rng(1)
    ims = [rng.uniform(-1.2, 1.2, (S, S, 3)).astype(np.float32)
           for _ in range(3)]
    assert np.array_equal(imaging.tensor2im(ims[0][None]),
                          jimaging.tensor2im(ims[0][None]))
    assert np.array_equal(imaging.make_grid(ims, nrow=2),
                          jimaging.make_grid(ims, nrow=2))
    imaging.save_grid(ims, str(tmp_path / "g" / "grid.png"))
    with Image.open(tmp_path / "g" / "grid.png") as im:
        assert np.array_equal(np.asarray(im), imaging.make_grid(ims))
    imaging.save_image(ims[1], str(tmp_path / "one.png"))
    assert (tmp_path / "one.png").exists()
    img = sorted(Path(dirs["img"]).iterdir())[3]       # the grayscale one
    mask = sorted(Path(dirs["mask"]).iterdir())[0]
    assert np.array_equal(imaging.load_image(str(img), S),
                          jimaging.load_image(str(img), S))
    m = imaging.load_mask(str(mask), S)
    assert np.array_equal(m, jimaging.load_mask(str(mask), S))
    assert set(np.unique(m)) == {0.0, 1.0}
