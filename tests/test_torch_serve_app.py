"""Port vs JAX: the WSGI serving app (serve/app.py) at the 64 px tiny
config, both apps over the same bridged weights, given the same WSGI calls.

Routes, status lines, `Location` and `Content-Type` must be the same, and
the HTML pages byte for byte.  The image a POST produces is held to the
serving parity of tests/test_torch_serving.py: the uint8 result floors
(x+1)*127.5, so a value within 1e-4 of an integer boundary may land one
LSB apart: at most 1 LSB, on at most 0.1% of pixels.  Also: the session
that restores G, P and VGG from a checkpoint of the port, bit for bit, and
one POST over a real socket.
"""

import io
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

from deepinpainting_tpu.serve import make_app as jax_make_app
from deepinpainting_tpu.serve.app import parse_multipart as jax_parse
from deepinpainting_torch.engine import inpaint as TI
from deepinpainting_torch.engine.checkpoint import CheckpointManager
from deepinpainting_torch.serve.app import (InferenceSession,
                                            encode_multipart, make_app,
                                            parse_multipart, post_over_socket)

from torch_port_helpers import configs, flat_dicts, jax_params, torch_models

S = 64


def img_bytes(seed=0, size=S, fmt="JPEG"):
    arr = np.random.default_rng(seed).integers(0, 255, (size, size, 3),
                                               dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, fmt)
    return buf.getvalue()


def mask_bytes(size=S, fmt="PNG"):
    arr = np.zeros((size, size, 3), np.uint8)
    lo, hi = size // 4, size // 2
    arr[lo:hi, lo + 4:hi + 8] = 255
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, fmt)
    return buf.getvalue()


def multipart_body(fields, boundary="testboundary123"):
    parts = []
    for name, payload in fields.items():
        parts.append(b"--" + boundary.encode() + b"\r\n"
                     b'Content-Disposition: form-data; name="' +
                     name.encode() + b'"; filename="f"\r\n'
                     b"Content-Type: application/octet-stream\r\n\r\n" +
                     payload + b"\r\n")
    parts.append(b"--" + boundary.encode() + b"--\r\n")
    return b"".join(parts), f"multipart/form-data; boundary={boundary}"


def upload(src=0, ref=1, fmt="JPEG", size=S):
    return multipart_body({"srcImage": img_bytes(src, size, fmt),
                           "binaryMask": mask_bytes(size),
                           "refImage": img_bytes(ref, size, fmt)})


def wsgi_call(app, method, path, body=b"", content_type=""):
    got = {}

    def start_response(status, headers):
        got["status"], got["headers"] = status, dict(headers)

    environ = {"REQUEST_METHOD": method, "PATH_INFO": path,
               "CONTENT_LENGTH": str(len(body)), "CONTENT_TYPE": content_type,
               "wsgi.input": io.BytesIO(body)}
    out = b"".join(app(environ, start_response))
    return got["status"], got["headers"], out


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    """(JAX app, port app) over the same weights."""
    jcfg, tcfg = configs(mask_type="random")
    params = jax_params(jcfg, seed=11)
    flats = flat_dicts(params, tmp_path_factory.mktemp("w"))
    jstate = SimpleNamespace(params_G=params["G"], params_P=params["P"],
                             vgg=params["vgg"])
    japp = jax_make_app(jcfg, None, str(tmp_path_factory.mktemp("js")),
                        state=jstate, warmup=False)
    tapp = make_app(tcfg, None, str(tmp_path_factory.mktemp("ts")),
                    state=torch_models(tcfg, flats), warmup=False,
                    device="cpu")
    return japp, tapp


def _same_response(apps, *call):
    (js, jh, jout), (ts, th, tout) = (wsgi_call(app, *call) for app in apps)
    assert ts == js
    for key in ("Location", "Content-Type"):
        assert th.get(key) == jh.get(key), key
    return (js, jh, jout), (ts, th, tout)


@pytest.mark.parametrize("fields", [
    {"a": b"xyz", "b": b"\x00\xffbin"},
    {"srcImage": b"\r\n--not-a-boundary\r\n", "binaryMask": b""},
    {"only": bytes(range(256)) * 3},
])
def test_parse_multipart_matches_jax(fields):
    body, ctype = multipart_body(fields, boundary="b0und4ry")
    assert parse_multipart(ctype, body) == jax_parse(ctype, body)
    assert parse_multipart(ctype, body) == fields


@pytest.mark.parametrize("fields", [
    {"srcImage": b"\xff\xd8 image", "binaryMask": b"mask\r\n--",
     "refImage": b""},
    {"a": bytes(range(256))},
])
def test_encode_multipart_round_trips(fields):
    """The client side (demo, chip_smoke) encodes what both apps parse."""
    body, ctype = encode_multipart(fields)
    assert parse_multipart(ctype, body) == jax_parse(ctype, body) == fields


def test_parse_multipart_refuses_what_jax_refuses():
    for parse in (parse_multipart, jax_parse):
        with pytest.raises(ValueError, match="multipart"):
            parse("text/plain", b"hello")


@pytest.mark.parametrize("path", ["/", "/result"])
def test_pages_match_jax(apps, path):
    (js, _, jout), (_, th, tout) = _same_response(apps, "GET", path)
    assert js == "200 OK"
    assert th["Content-Length"] == str(len(tout))
    assert tout == jout


@pytest.mark.parametrize("method,path,status", [
    ("GET", "/getImage", "302 Found"),
    ("GET", "/nope", "404 Not Found"),
    ("POST", "/result", "404 Not Found"),
    ("GET", "/static/../../../etc/passwd", "404 Not Found"),
    ("GET", "/static/img/none.jpg", "404 Not Found"),
    ("PUT", "/", "404 Not Found"),
])
def test_routes_match_jax(apps, method, path, status):
    (js, jh, _), _ = _same_response(apps, method, path)
    assert js == status
    if status.startswith("302"):
        assert jh["Location"] == "/result"


@pytest.mark.parametrize("fields,named", [
    ({"srcImage": img_bytes(0)}, ("binaryMask", "refImage")),
    ({"binaryMask": mask_bytes(), "refImage": img_bytes(1)}, ("srcImage",)),
    ({"srcImage": b"not an image", "binaryMask": mask_bytes(),
      "refImage": img_bytes(1)}, ("srcImage",)),
    ({"srcImage": img_bytes(0), "binaryMask": b"\x89PNG broken",
      "refImage": img_bytes(1)}, ("binaryMask",)),
])
def test_bad_uploads_are_400_as_in_jax(apps, fields, named):
    body, ctype = multipart_body(fields)
    (js, _, jout), (_, _, tout) = _same_response(apps, "POST", "/getImage",
                                                 body, ctype)
    assert js == "400 Bad Request"
    for name in named:
        assert name.encode() in tout and name.encode() in jout


@pytest.mark.parametrize("fmt,size", [("JPEG", S), ("PNG", S),
                                      ("JPEG", 80)])
def test_post_flow_matches_jax(apps, fmt, size):
    body, ctype = upload(2, 3, fmt, size)
    (js, jh, _), _ = _same_response(apps, "POST", "/getImage", body, ctype)
    assert js == "302 Found" and jh["Location"] == "/result"
    (js, _, jout), (_, _, tout) = _same_response(apps, "GET", "/result")
    assert js == "200 OK" and tout == jout
    (js, jh, _), (_, th, tout) = _same_response(apps, "GET",
                                                "/static/img/test.jpg")
    assert js == "200 OK" and th["Content-Type"] == "image/jpeg"
    assert th["Cache-Control"] == jh["Cache-Control"] == "no-store"
    assert Image.open(io.BytesIO(tout)).size == (S, S)
    # the image itself, before the JPEG encoder: the serving parity
    fields = parse_multipart(ctype, body)
    args = (fields["srcImage"], fields["binaryMask"], fields["refImage"])
    want = apps[0].session.run_bytes(*args)
    got = apps[1].session.run_bytes(*args)
    assert got.dtype == np.uint8 and got.shape == want.shape == (S, S, 3)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3


def test_run_bytes_is_run_on_the_decoded_arrays(apps):
    session = apps[1].session
    src, ref = img_bytes(4, 72), img_bytes(5, 72, "PNG")
    mask = mask_bytes(72)
    dec = lambda b: np.array(Image.open(io.BytesIO(b)).convert("RGB").resize(
        (S, S), Image.BILINEAR), np.uint8)
    hole = (dec(mask)[..., 0] > 0).astype(np.uint8)
    assert 0 < hole.mean() < 1
    want = session.run(dec(src)[None], hole[None], dec(ref)[None])[0]
    np.testing.assert_array_equal(session.run_bytes(src, mask, ref), want)


# ---- a session restored from a checkpoint of the port --------------------

@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A port checkpoint of a fresh tiny TrainState, epoch 3."""
    _, tcfg = configs(checkpoints_dir=str(tmp_path_factory.mktemp("ck")),
                      name="run")
    state = TI.create_state(tcfg, torch.Generator().manual_seed(5), "cpu")
    CheckpointManager(tcfg).save(3, state)
    return tcfg, state


def test_session_restores_g_p_vgg_bit_for_bit(checkpoint):
    cfg, state = checkpoint
    sess = InferenceSession(cfg, 3, device="cpu")
    assert type(sess.state) is TI.Models        # no D, F or optimisers
    for name in ("G", "P", "vgg"):
        net = getattr(sess.state, name)
        want = getattr(state, name).state_dict()
        got = net.state_dict()
        assert set(got) == set(want) and not net.training
        assert all(torch.equal(got[k], want[k]) for k in want)
    # and answers as a live session over the trained networks
    live = InferenceSession(cfg, state=TI.Models(
        state.G.eval(), state.P.eval(), state.vgg), device="cpu")
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (1, S, S, 3), dtype=np.uint8)
    mask = np.zeros((1, S, S), np.uint8)
    mask[:, 12:40, 20:44] = 1
    np.testing.assert_array_equal(sess.run(img, mask, img[:, ::-1]),
                                  live.run(img, mask, img[:, ::-1]))


def test_session_restore_refusals(checkpoint, tmp_path):
    cfg, state = checkpoint
    # sp=True outside a process group is the plain session, bit for bit
    # (the JAX package's rule on one device)
    sp, plain = (InferenceSession(cfg, 3, sp=flag, device="cpu")
                 for flag in (True, False))
    assert sp.grid is None
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (1, S, S, 3), dtype=np.uint8)
    mask = np.zeros((1, S, S), np.uint8)
    mask[:, 20:36, 16:40] = 1
    np.testing.assert_array_equal(sp.run(img, mask, img[:, ::-1]),
                                  plain.run(img, mask, img[:, ::-1]))
    with pytest.raises(FileNotFoundError, match="epoch 4"):
        InferenceSession(cfg, 4, device="cpu")
    # strict: a network that lacks a tensor of the checkpoint is refused
    with pytest.raises(RuntimeError, match="state_dict"):
        InferenceSession(cfg.replace(ngf=4, vgg_width_scale=1 / 16), 3,
                         device="cpu")


def test_make_app_serves_a_checkpoint_over_a_socket(checkpoint):
    """make_app(cfg, epoch) with its default static directory, on
    ThreadingWSGIServer at an ephemeral port: one real POST."""
    cfg, _ = checkpoint
    app = make_app(cfg, 3, device="cpu")
    assert app.static_dir == os.path.abspath(os.path.join(
        cfg.checkpoints_dir, cfg.name, "static"))
    status, location, _, jpg = post_over_socket(app, {
        "srcImage": img_bytes(6), "binaryMask": mask_bytes(),
        "refImage": img_bytes(7)})
    assert status == 302 and location == "/result"
    assert Image.open(io.BytesIO(jpg)).size == (S, S)
