"""The port's serving artifact (engine/export_model.py) on the CPU, at the
64 px tiny config with weights bridged from JAX parameters.

Export then load must give the live make_serving_fn's bytes bit for bit
at every batch from 1 to 9 (the same ATen ops and the same scan op on the
same inputs); the fixed-set dispatch must equal the live function called
the same way (padded and chunked); the artifact's npz files are the JAX
package's flat layout of the same weights, and its answers are within the
serving parity of tests/test_torch_serving.py against JAX's serving
function (at most 1 LSB, on at most 0.1% of pixels).
"""

import json
import os
import shutil
import threading
import zipfile

import numpy as np
import pytest
import torch

from deepinpainting_tpu.engine import inpaint as JI
from deepinpainting_torch import _cli
from deepinpainting_torch.engine import inpaint as TI
from deepinpainting_torch.engine import export_model as EM
from deepinpainting_torch.engine.checkpoint import CheckpointManager
from deepinpainting_torch.serve.app import InferenceSession, make_app

from test_torch_serve_app import upload, wsgi_call
from torch_port_helpers import configs, flat_dicts, jax_params, torch_models

S = 64


def _requests(b, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (b, S, S, 3), dtype=np.uint8)
    ref = rng.integers(0, 256, (b, S, S, 3), dtype=np.uint8)
    mask = np.zeros((b, S, S), np.uint8)
    for i in range(b):
        y, x = 8 + 3 * i, 10 + 2 * i
        mask[i, y:y + 24, x:x + 20] = 1
    return img, mask, ref


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    jcfg, tcfg = configs(mask_type="random", is_train=False)
    params = jax_params(jcfg, seed=21)
    flats = flat_dicts(params, tmp_path_factory.mktemp("w"))
    return jcfg, tcfg, params, flats, torch_models(tcfg, flats)


@pytest.fixture(scope="module")
def artifact(weights, tmp_path_factory):
    _, tcfg, _, _, models = weights
    out = str(tmp_path_factory.mktemp("export") / "artifact")
    EM.export_serving(tcfg, models, out, device="cpu")
    return out, EM.load_serving(out, "cpu")


@pytest.mark.parametrize("b", range(1, 10))
def test_loaded_call_equals_live_bit_for_bit(weights, artifact, b):
    _, tcfg, _, _, models = weights
    _, loaded = artifact
    img, mask, ref = _requests(b, seed=b)
    live = TI.make_serving_fn(tcfg, "cpu")(*models, img, mask, ref)
    got = loaded.call(loaded.G, loaded.P, loaded.vgg, img, mask, ref)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (b, S, S, 3)
    assert torch.equal(got, live)


def test_artifact_files_and_weights(weights, artifact):
    _, _, _, flats, _ = weights
    out, loaded = artifact
    assert sorted(os.listdir(out)) == sorted(
        [EM.FN_FILE, EM.META_FILE, EM.CFG_FILE, *EM.NPZ_FILES])
    with open(os.path.join(out, EM.META_FILE)) as f:
        assert json.load(f) == {"format": 2, "device": "cpu",
                                "batch": "symbolic"}
    assert loaded.batch == "symbolic" and loaded.cfg.fine_size == S
    # the npz files are the JAX flat layout of the same weights ...
    for name, npz in zip(("G", "P", "vgg"), EM.NPZ_FILES):
        with np.load(os.path.join(out, npz)) as raw:
            assert set(raw.files) == set(flats[name])
            for k in raw.files:
                np.testing.assert_array_equal(raw[k], flats[name][k])
    # ... and the graph carries none of them: its archive's tensor data
    # (weights, constants, sample inputs) is the hole fill's 12 bytes
    assert not loaded.exported["symbolic"].state_dict
    with zipfile.ZipFile(os.path.join(out, EM.FN_FILE)) as z:
        data = {i.filename: i.file_size for i in z.infolist()
                if "/data/" in i.filename and not i.filename.endswith(
                    ".json")}
    assert sum(data.values()) <= 4 * EM._MAX_LITERALS, data


def test_graph_calls_the_scan_op_and_not_kbar(artifact):
    _, loaded = artifact
    ops = EM.graph_ops(loaded.exported["symbolic"])
    assert "deepinpainting.scan_stream.default" in ops
    assert not any("kbar_build" in op for op in ops)


def test_artifact_within_serving_parity_of_jax(weights, artifact):
    jcfg, _, params, _, _ = weights
    _, loaded = artifact
    img, mask, ref = _requests(2, seed=30)
    want = np.asarray(JI.make_serving_fn(jcfg)(
        params["G"], params["P"], params["vgg"], img, mask, ref))
    got = loaded.call(loaded.G, loaded.P, loaded.vgg, img, mask,
                      ref).numpy()
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def test_fixed_batch_set_dispatch(weights, tmp_path):
    _, tcfg, _, _, models = weights
    out = str(tmp_path / "fixed")
    EM.export_serving(tcfg, models, out, batch_sizes=(4, 2), device="cpu")
    assert sorted(os.listdir(out)) == sorted(
        ["serving_b2.pt2", "serving_b4.pt2", EM.META_FILE, EM.CFG_FILE,
         *EM.NPZ_FILES])
    loaded = EM.load_serving(out, "cpu")
    assert loaded.batch == [2, 4]
    live = TI.make_serving_fn(tcfg, "cpu")

    def live_padded(img, mask, ref, take, b):
        pad = lambda a: np.concatenate([a, np.repeat(a[-1:], b - take, 0)])
        return live(*models, pad(img), pad(mask), pad(ref))[:take]

    for n, chunks in ((1, [2]), (3, [4]), (5, [4, 2]), (9, [4, 4, 2])):
        img, mask, ref = _requests(n, seed=40 + n)
        got = loaded.call(loaded.G, loaded.P, loaded.vgg, img, mask, ref)
        want, i = [], 0
        for b in chunks:
            take = min(b, n - i)
            want.append(live_padded(img[i:i + take], mask[i:i + take],
                                    ref[i:i + take], take, b))
            i += take
        assert tuple(got.shape) == (n, S, S, 3)
        assert torch.equal(got, torch.cat(want))
    with pytest.raises(ValueError, match="empty batch"):
        loaded.call(loaded.G, loaded.P, loaded.vgg, img[:0], mask[:0],
                    ref[:0])
    with pytest.raises(ValueError, match="positive"):
        EM.export_serving(tcfg, models, str(tmp_path / "bad"),
                          batch_sizes=(0, 2), device="cpu")


@pytest.mark.parametrize("n,want", [(1, [1]), (3, [8]), (8, [8]),
                                    (9, [8, 1]), (17, [8, 8, 1])])
def test_fixed_dispatch_picks_pads_and_chunks(n, want):
    seen = []

    def fake(G, P, vgg, image, mask, ref):
        seen.append(image.shape[0])
        assert mask.shape[0] == ref.shape[0] == image.shape[0]
        return image * 2

    call = EM._make_fixed_dispatch({1: fake, 8: fake})
    image = np.arange(n * 2, dtype=np.uint8).reshape(n, 2)
    out = call(None, None, None, image, image, image)
    assert seen == want
    np.testing.assert_array_equal(out.numpy(), image * 2)


def test_load_and_export_refusals(weights, artifact, tmp_path):
    _, tcfg, _, _, models = weights
    out, _ = artifact
    with pytest.raises(FileNotFoundError, match="no serving artifact"):
        EM.load_serving(str(tmp_path / "nothing"), "cpu")
    # attention_impl='torch' (or 'lax') exports: its graph calls the plain
    # scan's op in place of the kernel's
    for impl in ("torch", "lax"):
        EM.export_serving(tcfg.replace(attention_impl=impl), models,
                          str(tmp_path / impl), device="cpu")
        ops = EM.graph_ops(EM.load_serving(str(tmp_path / impl),
                                           "cpu").exported["symbolic"])
        assert f"{EM.PLAIN_SCAN_OP}.default" in ops
        assert f"{EM.SCAN_OP}.default" not in ops
    # an artifact serves on the device type it was exported on only
    moved = str(tmp_path / "moved")
    shutil.copytree(out, moved)
    with open(os.path.join(moved, EM.META_FILE)) as f:
        meta = json.load(f)
    with open(os.path.join(moved, EM.META_FILE), "w") as f:
        json.dump(dict(meta, device="cuda"), f)
    with pytest.raises(ValueError, match="'cuda'.*'cpu'"):
        EM.load_serving(moved, "cpu")


def test_from_export_serves_coalesced_requests(weights, artifact):
    _, tcfg, _, _, models = weights
    out, _ = artifact
    live = InferenceSession(tcfg, state=models, device="cpu")
    sess = InferenceSession.from_export(out, max_batch=4, batch_wait_ms=200.0,
                                        device="cpu")
    try:
        img, mask, ref = _requests(4, seed=50)
        results = [None] * 4
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, sess.run(img[i:i + 1], mask[i:i + 1], ref[i:i + 1])))
            for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        assert sess.calls == sess._batcher.batches_run < 4
        for i, got in enumerate(results):
            want = live.run(img[i:i + 1], mask[i:i + 1], ref[i:i + 1])
            # a coalesced batch runs the same per-sample math; the CPU's
            # conv blocking depends on the batch size: 1 LSB at most
            np.testing.assert_allclose(got.astype(int), want, atol=1)
    finally:
        sess.close()
    app = make_app(None, static_dir=os.path.join(out, "..", "static"),
                   from_export=out, device="cpu")
    body, ctype = upload(8, 9)
    status, headers, _ = wsgi_call(app, "POST", "/getImage", body, ctype)
    assert status == "302 Found" and headers["Location"] == "/result"


@pytest.mark.parametrize("extra", [["--quant", "none"], ["--sp"],
                                   ["--which_epoch", "3"],
                                   ["--random_weights"]])
def test_cli_from_export_refusals(extra, capsys):
    with pytest.raises(SystemExit) as e:
        _cli.serve(["--from_export", "some/dir", "--device", "cpu", *extra])
    assert e.value.code == 2
    assert "--from_export" in capsys.readouterr().err


def test_cli_export_of_a_checkpoint(weights, tmp_path, monkeypatch):
    """`_cli export` restores epoch 3 of a port checkpoint (its
    config.json) and exports it; the artifact answers as a session of the
    restored networks.  `--quant int8` exports and serves the int8 path;
    `--sp` outside torch.distributed.run builds the plain session."""
    _, tcfg, _, _, _ = weights
    ckpt = str(tmp_path / "ck")
    cfg = tcfg.replace(checkpoints_dir=ckpt, name="run", is_train=True)
    state = TI.create_state(cfg, torch.Generator().manual_seed(8), "cpu")
    CheckpointManager(cfg).save(3, state)
    base = ["--checkpoints_dir", ckpt, "--name", "run", "--device", "cpu"]
    out = str(tmp_path / "art")
    _cli.export([*base, "--which_epoch", "3", "--out", out])
    sess = InferenceSession.from_export(out, device="cpu")
    live = InferenceSession(cfg, 3, device="cpu")
    img, mask, ref = _requests(1, seed=60)
    np.testing.assert_array_equal(sess.run(img, mask, ref),
                                  live.run(img, mask, ref))
    q_out = str(tmp_path / "q")
    _cli.export([*base, "--quant", "int8", "--which_epoch", "3", "--out",
                 q_out])
    q_sess = InferenceSession.from_export(q_out, device="cpu")
    q_live = InferenceSession(cfg.replace(quant="int8"), 3, device="cpu")
    assert q_sess.cfg.quant == "int8"
    np.testing.assert_array_equal(q_sess.run(img, mask, ref),
                                  q_live.run(img, mask, ref))
    # `serve --quant int8` builds an int8 session (its server not started)
    served = {}

    class _Server:
        def serve_forever(self):
            served["ran"] = True

    def make_server(host, port, app, server_class=None):
        served["app"] = app
        return _Server()

    import wsgiref.simple_server
    monkeypatch.setattr(wsgiref.simple_server, "make_server", make_server)
    _cli.serve([*base, "--quant", "int8", "--random_weights"])
    assert served["ran"] and served["app"].session.cfg.quant == "int8"
    # `serve --sp` builds its session (one rank: the plain one), its
    # server not started
    served.clear()
    _cli.serve([*base, "--sp", "--random_weights"])
    assert served["ran"] and served["app"].session.grid is None
