"""The serving artifact across platforms (engine/export_model.py) on the
CPU, at the 64 px tiny config with weights from a seed: `platforms`
traces one graph per device type over one copy of the weights
(meta.json format 3), an artifact without them (format 2, one device
type) still loads, a device type the artifact has no graph for is
refused by naming the ones it has, and a 'cuda' graph is refused by name
where no card can trace it.

attention_impl='torch' (the JAX package's 'lax') exports a graph whose
attention is one `deepinpainting::scan_stream_plain` node: no
`deepinpainting::scan_stream` node, and no loop over the N = 64
attention positions unrolled into it (its node count is the kernel
graph's), bit for bit with the live attention_impl='torch' serving
function.  `_cli export --platforms --attention_impl` writes the same.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from deepinpainting_torch import _cli
from deepinpainting_torch.config import Config
from deepinpainting_torch.engine import export_model as EM
from deepinpainting_torch.engine import inpaint as TI
from deepinpainting_torch.serve.app import InferenceSession

from torch_port_helpers import TINY

S = 64
N = (S // 8) ** 2       # attention positions


def _requests(b, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (b, S, S, 3), dtype=np.uint8)
    mask = np.zeros((b, S, S), np.uint8)
    for i in range(b):
        mask[i, 8 + 3 * i:32 + 3 * i, 10 + 2 * i:30 + 2 * i] = 1
    return img, mask, img[::-1].copy()


@pytest.fixture(scope="module")
def weights():
    cfg = Config(**TINY, mask_type="random", is_train=False)
    return cfg, TI.init_params(cfg, torch.Generator().manual_seed(2), "cpu")


@pytest.fixture(scope="module")
def artifacts(weights, tmp_path_factory):
    """{impl: directory} of platforms=['cpu'] artifacts."""
    cfg, models = weights
    out = {}
    for impl in ("cuda", "torch"):
        out[impl] = str(tmp_path_factory.mktemp(impl) / "art")
        EM.export_serving(cfg.replace(attention_impl=impl), models,
                          out[impl], platforms=["cpu"])
    return out


def test_platforms_artifact_layout_and_meta(weights, artifacts):
    cfg, models = weights
    out = artifacts["cuda"]
    assert sorted(os.listdir(out)) == sorted(
        ["serving_cpu.pt2", EM.META_FILE, EM.CFG_FILE, *EM.NPZ_FILES])
    with open(os.path.join(out, EM.META_FILE)) as f:
        assert json.load(f) == {"format": 3, "platforms": ["cpu"],
                                "batch": {"cpu": "symbolic"}}
    loaded = EM.load_serving(out, "cpu")
    assert loaded.batch == "symbolic"
    img, mask, ref = _requests(2, seed=1)
    assert torch.equal(loaded.call(loaded.G, loaded.P, loaded.vgg, img, mask,
                                   ref),
                       TI.make_serving_fn(cfg, "cpu")(*models, img, mask,
                                                      ref))


def test_format_2_artifact_still_loads(weights, tmp_path):
    cfg, models = weights
    out = str(tmp_path / "one")
    EM.export_serving(cfg, models, out, device="cpu", batch_sizes=(1,))
    with open(os.path.join(out, EM.META_FILE)) as f:
        assert json.load(f) == {"format": 2, "device": "cpu", "batch": [1]}
    loaded = EM.load_serving(out, "cpu")
    img, mask, ref = _requests(1, seed=2)
    assert torch.equal(loaded.call(loaded.G, loaded.P, loaded.vgg, img, mask,
                                   ref),
                       TI.make_serving_fn(cfg, "cpu")(*models, img, mask,
                                                      ref))


def test_device_outside_the_list_is_refused(artifacts, tmp_path):
    moved = str(tmp_path / "cuda_only")
    shutil.copytree(artifacts["cuda"], moved)
    with open(os.path.join(moved, EM.META_FILE), "w") as f:
        json.dump({"format": 3, "platforms": ["cuda"],
                   "batch": {"cuda": "symbolic"}}, f)
    with pytest.raises(ValueError, match=r"platforms \['cuda'\] and none "
                                         r"for 'cpu'"):
        EM.load_serving(moved, "cpu")


def test_cuda_platform_without_a_card_is_refused(weights, tmp_path,
                                                 monkeypatch):
    cfg, models = weights
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="platform 'cuda' needs a CUDA "
                                           "device"):
        EM.export_serving(cfg, models, str(tmp_path / "a"),
                          platforms=["cuda", "cpu"])
    with pytest.raises(ValueError, match="one or more of"):
        EM.export_serving(cfg, models, str(tmp_path / "b"),
                          platforms=["tpu"])
    assert not os.path.exists(tmp_path / "a")     # refused before a write
    with pytest.raises(RuntimeError, match="platform 'cuda' needs a CUDA "
                                           "device"):
        _cli.export(["--random_weights", "--out", str(tmp_path / "c"),
                     "--platforms", "cuda,cpu"])


def test_torch_impl_graph_holds_the_plain_op_and_no_loop(weights,
                                                         artifacts):
    cfg, models = weights
    graphs = {impl: EM.load_serving(out, "cpu")
              for impl, out in artifacts.items()}
    ops = EM.graph_ops(graphs["torch"].exported["symbolic"])
    assert f"{EM.PLAIN_SCAN_OP}.default" in ops
    assert not any(op.startswith(f"{EM.SCAN_OP}.") for op in ops)
    assert f"{EM.SCAN_OP}.default" in EM.graph_ops(
        graphs["cuda"].exported["symbolic"])
    # one op node for another: an unrolled recurrence would add several
    # nodes for each of the N steps
    nodes = {impl: len(g.exported["symbolic"].graph.nodes)
             for impl, g in graphs.items()}
    assert nodes["torch"] == nodes["cuda"] and N > 8
    loaded = graphs["torch"]
    assert loaded.cfg.attention_impl == "torch"
    live = TI.make_serving_fn(cfg.replace(attention_impl="torch"), "cpu")
    for b in (1, 3):
        img, mask, ref = _requests(b, seed=10 + b)
        assert torch.equal(
            loaded.call(loaded.G, loaded.P, loaded.vgg, img, mask, ref),
            live(*models, img, mask, ref))


def test_cli_export_platforms_and_attention_impl(weights, tmp_path):
    cfg, _ = weights
    ck = tmp_path / "ck"
    os.makedirs(ck / "run")
    cfg.save(str(ck / "run" / "config.json"))
    out = str(tmp_path / "art")
    _cli.export(["--checkpoints_dir", str(ck), "--name", "run",
                 "--random_weights", "--out", out, "--platforms", "cpu,cpu",
                 "--attention_impl", "lax"])
    with open(os.path.join(out, EM.META_FILE)) as f:
        assert json.load(f) == {"format": 3, "platforms": ["cpu"],
                                "batch": {"cpu": "symbolic"}}
    sess = InferenceSession.from_export(out, device="cpu")
    assert sess.cfg.attention_impl == "lax"
    assert f"{EM.PLAIN_SCAN_OP}.default" in EM.graph_ops(
        sess.state.exported["symbolic"])
    img, mask, ref = _requests(1, seed=30)
    live = InferenceSession(cfg.replace(attention_impl="lax"), device="cpu")
    np.testing.assert_array_equal(sess.run(img, mask, ref),
                                  live.run(img, mask, ref))
