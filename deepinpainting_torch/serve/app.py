"""Web serving app: the browser mask-painting demo backed by the port's
serving function (counterpart of deepinpainting_tpu/serve/app.py).

The HTTP surface is the JAX package's, route for route:
    GET  /          -> mask-painting page (templates/index.html)
    POST /getImage  -> multipart fields `srcImage`, `binaryMask`, `refImage`;
                       runs the model, writes static/img/test.jpg, 302 ->
                       /result
    GET  /getImage  -> 302 -> /result without running the model
    GET  /result    -> page showing static/img/test.jpg
    GET  /static/*  -> static assets, inside the static directory only
A missing field or an upload that does not decode is a 400, anything else
a 404.  It is a dependency-free WSGI application: any WSGI server can host
it, and `_cli.py serve` runs it on ThreadingWSGIServer.

InferenceSession holds the networks (from a checkpoint of the port, from
memory, or fresh from cfg.seed) or a loaded serving artifact
(engine/export_model.py); every request is one call of the uint8-in /
uint8-out serving function (engine/inpaint.py::make_serving_fn).  With
max_batch > 1 concurrent single requests coalesce into one batched call
(serve/batcher.py).

With sp=True in a torch.distributed group of more than one rank (`_cli.py
serve --sp` under torch.distributed.run) one request's rows spread over
every rank (parallel/spatial.py): rank 0 serves, and every other rank
runs `follow()`, which takes each call's arrays by broadcast from rank 0,
runs its slab of the sharded forward, and returns when rank 0's session
closes.  Each rank holds rank 0's weights.  The uint8 result is gathered
on every rank; rank 0 returns it.  With one rank, or outside any group,
sp=True is the plain session, as the JAX package's is on one device.
"""

from __future__ import annotations

import http.client
import io
import os
import threading
import time
from email.parser import BytesParser
from email.policy import HTTP
from socketserver import ThreadingMixIn
from typing import Dict, Optional, Tuple
from wsgiref.simple_server import WSGIServer, make_server

import numpy as np
import torch
import torch.distributed as dist
from PIL import Image

from ..config import Config
from ..device import DeviceLike, resolve_device
from ..engine.checkpoint import CheckpointManager
from ..engine.inpaint import init_params, make_serving_fn
from ..parallel import collectives, mesh, spatial

_TEMPLATE_DIR = os.path.join(os.path.dirname(__file__), "templates")


def parse_multipart(content_type: str, body: bytes) -> Dict[str, bytes]:
    """Parse multipart/form-data into {field_name: file_bytes}."""
    parser = BytesParser(policy=HTTP)
    msg = parser.parsebytes(
        b"Content-Type: " + content_type.encode() + b"\r\n\r\n" + body)
    if not msg.is_multipart():
        raise ValueError("expected multipart/form-data")
    fields: Dict[str, bytes] = {}
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        if name:
            fields[name] = part.get_payload(decode=True) or b""
    return fields


# what rank 0 of an sp session broadcasts before a call's arrays
_STOP, _RUN = 0, 1
_WIRE_DTYPES = (torch.uint8, torch.float32)


class InferenceSession:
    """state: Models(G, P, vgg) on `device` in eval mode, as init_params
    returns them (or, with serve_fn, what serve_fn takes).  With state None, `which_epoch` restores G, P and VGG of
    that epoch from the port's checkpoint under
    {cfg.checkpoints_dir}/{cfg.name} (CheckpointManager.restore_models),
    and no epoch draws fresh weights from cfg.seed.  sp: spread each
    request's rows over the ranks of the torch.distributed group (see the
    module docstring); every rank constructs the session, rank 0 serves
    and the others call follow()."""

    def __init__(self, cfg: Config, which_epoch: Optional[int] = None, *,
                 state=None, serve_fn=None, max_batch: int = 1,
                 batch_wait_ms: float = 2.0, sp: bool = False,
                 device: DeviceLike = None):
        """serve_fn: a prebuilt (G, P, vgg, image, mask, ref) -> uint8
        call over `state`'s .G/.P/.vgg (from_export passes the loaded
        graph); None builds make_serving_fn."""
        self.device = resolve_device(device)
        self.cfg = cfg.replace(is_train=False, mask_type="random",
                               batch_size=1)
        if state is None and which_epoch is not None:
            state = CheckpointManager(self.cfg).restore_models(
                which_epoch, self.device)
        elif state is None:
            gen = torch.Generator().manual_seed(self.cfg.seed)
            state = init_params(self.cfg, gen, self.device)
        self.state = state
        group = mesh.default_group() if sp else None
        self.grid = None
        if group is not None and dist.get_world_size(group) > 1:
            self.grid = spatial.make_sp_group(group)
            collectives.broadcast_([t for net in state for t in
                                    net.state_dict().values()], group)
        self._infer = serve_fn or make_serving_fn(self.cfg, self.device,
                                                  self.grid)
        self._closed = False
        self._lock = threading.Lock()   # device calls serialize
        self.calls = 0                  # batched serving calls made
        self._batcher = None
        if max_batch > 1:
            from .batcher import MicroBatcher
            self._batcher = MicroBatcher(
                lambda s: self._call(s["image"], s["mask"], s["ref"]),
                max_batch, batch_wait_ms)

    @classmethod
    def from_export(cls, artifact_dir: str, *, max_batch: int = 1,
                    batch_wait_ms: float = 2.0,
                    device: DeviceLike = None) -> "InferenceSession":
        """Serve a serving artifact (engine/export_model.py): the graph is
        loaded, not traced, and the networks are not built.  Its batch is
        symbolic or dispatched over a fixed set, so coalescing (max_batch)
        works as in a live session."""
        from ..engine.export_model import load_serving
        loaded = load_serving(artifact_dir, device)
        # .state is the loaded namespace: .G / .P / .vgg, the graph's weights
        return cls(loaded.cfg, state=loaded, serve_fn=loaded.call,
                   max_batch=max_batch, batch_wait_ms=batch_wait_ms,
                   device=loaded.device)

    def _call(self, image, mask, ref) -> np.ndarray:
        with self._lock:
            if self.grid is not None:
                self._send(_RUN, image, mask, ref)
            u8 = self._run_slab(image, mask, ref)
            self.calls += 1
            return u8.cpu().numpy()

    def _run_slab(self, image, mask, ref):
        """The serving call on this rank's slab of the request (the whole
        request without a grid)."""
        if self.grid is not None:
            part = spatial.slab({"image": image, "mask": mask, "ref": ref},
                                self.grid)
            image, mask, ref = part["image"], part["mask"], part["ref"]
        return self._infer(self.state.G, self.state.P, self.state.vgg,
                           image, mask, ref)

    def _send(self, op: int, *arrays) -> None:
        """Rank 0: the call's header (op, the batch's B, H, W and each
        array's dtype), then the arrays, broadcast to the group."""
        group = self.grid.world
        dev = collectives.collective_device(group)
        tensors = [torch.as_tensor(np.ascontiguousarray(a)) for a in arrays]
        for t in tensors:
            if t.dtype not in _WIRE_DTYPES:
                raise ValueError(f"an sp session takes uint8 or float32 "
                                 f"arrays, not {t.dtype}")
        header = [op] + (list(tensors[0].shape[:3])
                         + [_WIRE_DTYPES.index(t.dtype) for t in tensors]
                         if tensors else [0] * 6)
        dist.broadcast(torch.tensor(header, device=dev),
                       src=dist.get_global_rank(group, 0), group=group)
        if tensors:
            collectives.broadcast_([t.to(dev) for t in tensors], group)

    def follow(self) -> None:
        """The loop of every rank but 0 of an sp session: each of rank 0's
        calls, on this rank's slab, until rank 0 closes its session."""
        if self.grid is None or self.grid.sp_index == 0:
            raise RuntimeError("follow() is for ranks other than 0 of a "
                               "session made with sp=True in a group")
        group = self.grid.world
        dev = collectives.collective_device(group)
        src = dist.get_global_rank(group, 0)
        while True:
            header = torch.zeros(7, dtype=torch.int64, device=dev)
            dist.broadcast(header, src=src, group=group)
            op, b, h, w, *codes = header.tolist()
            if op == _STOP:
                return
            arrays = [torch.empty(shape, dtype=_WIRE_DTYPES[c], device=dev)
                      for shape, c in zip(((b, h, w, 3), (b, h, w),
                                           (b, h, w, 3)), codes)]
            collectives.broadcast_(arrays, group)
            with self._lock:
                self._run_slab(*arrays)
                self.calls += 1

    def warmup(self) -> None:
        # uint8, as run_bytes sends it
        s = self.cfg.fine_size
        z = np.zeros((1, s, s, 3), np.uint8)
        self.run(z, np.zeros((1, s, s), np.uint8), z)

    def run(self, image: np.ndarray, mask: np.ndarray, ref: np.ndarray
            ) -> np.ndarray:
        """image/ref: [1,H,W,3] uint8 (or [-1,1] f32); mask: [1,H,W] uint8
        0/1 (or f32).  Returns the inpainted uint8 [1,H,W,3]."""
        if self._batcher is not None and image.shape[0] == 1:
            u8 = self._batcher.submit(
                {"image": image[0], "mask": mask[0], "ref": ref[0]})
            return u8[None]
        return self._call(image, mask, ref)

    def run_bytes(self, src: bytes, mask: bytes, ref: bytes) -> np.ndarray:
        """Decode uploaded bytes (RGB, bilinear resize to fine_size, the
        mask's channel 0 > 0) and inpaint.  Returns uint8 [H,W,3]; an
        upload that does not decode raises ValueError."""
        s = self.cfg.fine_size

        def dec(b, what):
            try:
                return np.array(Image.open(io.BytesIO(b)).convert(
                    "RGB").resize((s, s), Image.BILINEAR), np.uint8)
            except Exception as e:
                raise ValueError(f"could not decode {what}: {e}") from e

        image = dec(src, "srcImage")
        hole = (dec(mask, "binaryMask")[..., 0] > 0).astype(np.uint8)
        return self.run(image[None], hole[None], dec(ref, "refImage")[None])[0]

    def close(self) -> None:
        """Stop the batcher; on rank 0 of an sp session, release the
        followers (once)."""
        if self._batcher is not None:
            self._batcher.close()
        with self._lock:
            if (self.grid is not None and self.grid.sp_index == 0
                    and not self._closed):
                self._send(_STOP)
            self._closed = True


class InpaintApp:
    """The WSGI application."""

    def __init__(self, session: InferenceSession, static_dir: str):
        self.session = session
        self.static_dir = os.path.abspath(static_dir)
        os.makedirs(os.path.join(self.static_dir, "img"), exist_ok=True)

    def _render(self, name: str, **ctx) -> bytes:
        with open(os.path.join(_TEMPLATE_DIR, name)) as f:
            html = f.read()
        for k, v in ctx.items():
            html = html.replace("{{ %s }}" % k, str(v))
        return html.encode()

    def __call__(self, environ, start_response):
        method = environ["REQUEST_METHOD"]
        path = environ.get("PATH_INFO", "/")
        try:
            if path == "/" and method == "GET":
                return self._ok(start_response, self._render("index.html"))
            if path == "/getImage":
                if method != "POST":
                    return self._redirect(start_response, "/result")
                return self._get_image(environ, start_response)
            if path == "/result" and method == "GET":
                return self._ok(start_response, self._render("result.html"))
            if path.startswith("/static/") and method == "GET":
                return self._static(start_response, path[len("/static/"):])
            return self._error(start_response, "404 Not Found", "not found")
        except ValueError as e:
            return self._error(start_response, "400 Bad Request", str(e))

    def _get_image(self, environ, start_response):
        length = int(environ.get("CONTENT_LENGTH") or 0)
        body = environ["wsgi.input"].read(length)
        fields = parse_multipart(environ.get("CONTENT_TYPE", ""), body)
        missing = [k for k in ("srcImage", "binaryMask", "refImage")
                   if not fields.get(k)]
        if missing:
            raise ValueError(f"missing upload field(s): {', '.join(missing)}")
        fake_B = self.session.run_bytes(
            fields["srcImage"], fields["binaryMask"], fields["refImage"])
        out_path = os.path.join(self.static_dir, "img", "test.jpg")
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        Image.fromarray(fake_B).save(out_path)
        return self._redirect(start_response, "/result")

    def _static(self, start_response, rel: str):
        full = os.path.abspath(os.path.join(self.static_dir, rel))
        if not full.startswith(self.static_dir + os.sep) or not \
                os.path.isfile(full):
            return self._error(start_response, "404 Not Found", "not found")
        ctype = ("image/jpeg" if full.endswith((".jpg", ".jpeg")) else
                 "image/png" if full.endswith(".png") else
                 "text/css" if full.endswith(".css") else
                 "application/javascript" if full.endswith(".js") else
                 "application/octet-stream")
        with open(full, "rb") as f:
            data = f.read()
        start_response("200 OK", [("Content-Type", ctype),
                                  ("Content-Length", str(len(data))),
                                  ("Cache-Control", "no-store")])
        return [data]

    def _ok(self, start_response, body: bytes):
        start_response("200 OK", [("Content-Type", "text/html; charset=utf-8"),
                                  ("Content-Length", str(len(body)))])
        return [body]

    def _redirect(self, start_response, location: str):
        start_response("302 Found", [("Location", location),
                                     ("Content-Length", "0")])
        return [b""]

    def _error(self, start_response, status: str, message: str):
        body = message.encode()
        start_response(status, [("Content-Type", "text/plain"),
                                ("Content-Length", str(len(body)))])
        return [body]


class ThreadingWSGIServer(ThreadingMixIn, WSGIServer):
    """wsgiref's server with a thread a request, so that max_batch > 1 can
    coalesce concurrent requests (wsgiref's default server is serial)."""
    daemon_threads = True


def encode_multipart(fields: Dict[str, bytes], boundary: str = "formboundary"
                     ) -> Tuple[bytes, str]:
    """(body, Content-Type) of a multipart/form-data POST of `fields`
    ({name: bytes}), as a browser sends the demo's three files."""
    body = b"".join(
        b"--" + boundary.encode() + b"\r\nContent-Disposition: form-data; "
        b'name="' + k.encode() + b'"; filename="f"\r\n\r\n' + v + b"\r\n"
        for k, v in fields.items()) + b"--" + boundary.encode() + b"--\r\n"
    return body, f"multipart/form-data; boundary={boundary}"


def post_over_socket(app, fields: Dict[str, bytes]):
    """Host the WSGI `app` on ThreadingWSGIServer at an ephemeral
    127.0.0.1 port, POST `fields` to /getImage and fetch the result image.
    Returns (status, Location, ms of the POST, the result's bytes)."""
    server = make_server("127.0.0.1", 0, app,
                         server_class=ThreadingWSGIServer)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        body, ctype = encode_multipart(fields)
        conn = http.client.HTTPConnection("127.0.0.1", server.server_port,
                                          timeout=300)
        t0 = time.perf_counter()
        conn.request("POST", "/getImage", body, {"Content-Type": ctype})
        res = conn.getresponse()
        res.read()
        ms = (time.perf_counter() - t0) * 1e3
        conn.request("GET", "/static/img/test.jpg")
        img = conn.getresponse().read()
        conn.close()
        return res.status, res.getheader("Location"), ms, img
    finally:
        server.shutdown()
        server.server_close()
        thread.join(10)


def make_app(cfg: Config, which_epoch: Optional[int] = None,
             static_dir: Optional[str] = None, *, state=None,
             warmup: bool = True, max_batch: int = 1,
             batch_wait_ms: float = 2.0, sp: bool = False,
             from_export: Optional[str] = None,
             device: DeviceLike = None) -> InpaintApp:
    """The WSGI app over a session of the networks (`state`, checkpoint
    epoch `which_epoch`, or fresh from cfg.seed) or of the artifact
    `from_export`.  The static directory defaults to
    {cfg.checkpoints_dir}/{cfg.name}/static."""
    if from_export:
        session = InferenceSession.from_export(
            from_export, max_batch=max_batch, batch_wait_ms=batch_wait_ms,
            device=device)
        cfg = session.cfg
    else:
        session = InferenceSession(cfg, which_epoch, state=state,
                                   max_batch=max_batch,
                                   batch_wait_ms=batch_wait_ms, sp=sp,
                                   device=device)
    if warmup:
        session.warmup()
    return InpaintApp(session, static_dir or os.path.join(
        cfg.checkpoints_dir, cfg.name, "static"))
