"""Serving artifact (torch.export): trace once, load with no tracing
(counterpart of deepinpainting_tpu/engine/export_model.py).

`export_serving` traces the uint8 serving function
(engine/inpaint.py::serving_body) with torch.export and writes the graph
next to the config and the three networks' flat .npz weights;
`load_serving` reads the directory back into a callable with
make_serving_fn's signature, (G, P, vgg, image_u8, mask_u8, ref_u8) ->
uint8, that serves any request batch.

Platforms.  `platforms` (jax.export's names for the two device types the
port serves on, "cuda" and "cpu") traces one graph per platform, each on
a device of its type, over the artifact's one copy of the weights, and
load_serving picks the graph of its device's type.  A graph traces on
its own platform only: a "cuda" graph needs the card, and on a machine
without one the export is refused by name (a graph traced on the CPU is
another graph).  With no `platforms` the artifact holds one graph, for
the device type it was exported on (the layout below, format 2).

Artifact directory layout::

    meta.json         {"format": 3, "platforms": ["cuda", "cpu"],
                       "batch": {"cuda": "symbolic", "cpu": [1, 8]}}
    serving_{p}.pt2   platform p's symbolic-batch graph (torch.export.save)
      — or —
    serving_{p}_b{n}.pt2   one fixed-batch graph per n in meta's list
    config.json       the Config the function was traced with
    params_G.npz / params_P.npz / vgg.npz
                      flat weights in the JAX package's key layout
                      (engine/checkpoint.py::export_network_npz)

or, with no `platforms`, meta.json {"format": 2, "batch": "symbolic" |
[1, 8], "device": "cuda" | "cpu"} and serving.pt2 / serving_b{n}.pt2.

Weights.  The graph takes G's, P's and VGG's state_dicts as arguments, as
the JAX graph takes its parameter trees, so a .pt2 file carries no weight
(export_serving checks that the graph holds no state and no constant
tensor but the code's literals, and saves no example inputs): the .npz
files are the artifact's one copy of the weights.  At load each loads
strictly into its network built on the meta device (no weight is
allocated or drawn before it), and the tensors move to the device once.

Batch.  By default each graph is traced with a symbolic batch dimension,
Dim("b", min=1), at an example batch of 2 (a traced batch of 1 would
become a constant of the graph).  If that export fails for a platform,
the fixed set FALLBACK_BATCHES is exported for it instead, and the
platform and the reason are printed; an explicit `batch_sizes` forces
the fixed set.  A fixed-set graph serves any batch by pad-and-chunk
dispatch (`_make_fixed_dispatch`).  Any other failure to trace a
requested platform fails the export.  Errors from writing the files
always propagate.

Attention.  attention_impl 'cuda' (or 'pallas') traces one
`deepinpainting::scan_stream` node, the custom op that launches the
kernel on the card (ops/attention.py); 'torch' (or 'lax', the JAX
package's CPU-portable graph) traces one `deepinpainting::scan_stream_plain`
node, the plain recurrence on every device with no kernel library.

Differences from the JAX artifact:
  * it is not free of model code: the graph calls the port's custom ops,
    so loading needs the port's op library, which load_serving imports,
    and the 'cuda' graph of a 'cuda' attention on the card the nvcc-built
    kernel library, which _build.py compiles at the op's first call.
    JAX's artifact needs no model code.
  * a graph moves its inputs to its platform's device: load_serving
    refuses a device type the artifact has no graph for, by naming the
    ones it has.
  * export traces under no_grad with the weights as plain tensor inputs,
    so the attention takes its kbar-free primal: the graph calls the scan
    op and never the kbar op.

The config's conv modes are traced in, as in JAX: an int8 config's graph
quantises its eligible convs and multiplies with `aten._int_mm`, and the
pack modes' rewrites are ordinary convs of the graph.  config.json
records them, and load_serving serves the graph as it was traced.
"""

from __future__ import annotations

import json
import os
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..config import Config
from ..device import DeviceLike, resolve_device
from ..ops.attention import OP_NAMESPACE
from .checkpoint import export_network_npz
from .inpaint import Models, _as_tensor, build_models, serving_body

FN_FILE = "serving.pt2"
META_FILE = "meta.json"
CFG_FILE = "config.json"
NETS = ("G", "P", "vgg")
NPZ_FILES = ("params_G.npz", "params_P.npz", "vgg.npz")
FALLBACK_BATCHES = (1, 8)
PLATFORMS = ("cuda", "cpu")
# the graph's constant tensors are the code's literals (ops/masks.py's
# three hole-fill values); a network tensor would be far larger
_MAX_LITERALS = 64
SCAN_OP = f"{OP_NAMESPACE}.scan_stream"
PLAIN_SCAN_OP = f"{OP_NAMESPACE}.scan_stream_plain"
KBAR_OP = f"{OP_NAMESPACE}.kbar_build"


def _weights(net: nn.Module) -> Dict[str, torch.Tensor]:
    """The tensors of `net` that the graph takes: its parameters and
    running statistics (`num_batches_tracked` is read in train mode only)."""
    return {k: v.detach() for k, v in net.state_dict().items()
            if not k.endswith("num_batches_tracked")}


class _Nets(nn.Module):
    """G, P and VGG under one root, whose forward is the serving body."""

    def __init__(self, models: Models, serve):
        super().__init__()
        self.G, self.P, self.vgg = models
        self._serve = serve

    def forward(self, gt, mask, ref):
        return self._serve(self.G, self.P, self.vgg, gt, mask, ref)


class _Serving(nn.Module):
    """What is exported: serve(G_sd, P_sd, vgg_sd, gt, mask, ref) with the
    networks' tensors swapped in from the arguments.  The networks are held
    outside the module's state, so the graph lifts none of them."""

    def __init__(self, nets: _Nets):
        super().__init__()
        self._nets = (nets,)

    def forward(self, G, P, vgg, gt, mask, ref):
        tensors = {f"{name}.{k}": v for name, sd in zip(NETS, (G, P, vgg))
                   for k, v in sd.items()}
        return torch.func.functional_call(self._nets[0], tensors,
                                          (gt, mask, ref))


def _example(cfg: Config, batch: int, dev: torch.device):
    s = cfg.fine_size
    mask = torch.zeros((batch, s, s), dtype=torch.uint8, device=dev)
    mask[:, s // 4:3 * s // 4, s // 4:3 * s // 4] = 1
    img = torch.zeros((batch, s, s, 3), dtype=torch.uint8, device=dev)
    return img, mask, img.clone()


def _export(cfg: Config, models: Models, dev: torch.device, batch,
            ) -> torch.export.ExportedProgram:
    """The serving graph on `dev` at `batch`: an int, or None for a
    symbolic batch traced at an example batch of 2.  The weights are
    models' tensors moved to `dev`."""
    module = _Serving(_Nets(models, serving_body(cfg, dev)))
    sds = tuple({k: v.to(dev) for k, v in _weights(net).items()}
                for net in models)
    example = _example(cfg, batch or 2, dev)
    dims = None
    if batch is None:
        b = torch.export.Dim("b", min=1)
        dims = (*({k: None for k in sd} for sd in sds),
                {0: b}, {0: b}, {0: b})
    with torch.no_grad():
        ep = torch.export.export(module, (*sds, *example),
                                 dynamic_shapes=dims, strict=False)
    literals = sum(t.numel() for t in ep.constants.values()
                   if isinstance(t, torch.Tensor))
    if ep.state_dict or literals > _MAX_LITERALS:
        raise RuntimeError(
            "the serving graph holds weights of its own: "
            f"{sorted(ep.state_dict)[:5]} {sorted(ep.constants)[:5]}")
    ep.example_inputs = None    # torch.export.save would write the weights
    return ep


def graph_ops(ep: torch.export.ExportedProgram) -> set:
    """The names of the operators the graph calls, e.g.
    'deepinpainting.scan_stream.default'."""
    return {str(n.target) for n in ep.graph.nodes
            if n.op == "call_function"}


def check_platforms(platforms: Sequence[str]) -> List[str]:
    """`platforms` without repeats, in order, each one of PLATFORMS;
    'cuda' only where a card can trace its graph.  Raises ValueError or
    RuntimeError naming the platform."""
    out = list(dict.fromkeys(platforms))
    bad = [p for p in out if p not in PLATFORMS]
    if not out or bad:
        raise ValueError(f"platforms must name one or more of "
                         f"{list(PLATFORMS)}, got {list(platforms)!r}")
    if "cuda" in out and not torch.cuda.is_available():
        raise RuntimeError(
            "platform 'cuda' needs a CUDA device to trace its graph and none "
            "is available; export it where a card is (a graph traced on "
            "the CPU would be the CPU's graph)")
    return out


def _trace(cfg: Config, models: Models, dev: torch.device,
           batch_sizes: Optional[Sequence[int]], stem: str):
    """The graphs of one platform, {file name: ExportedProgram}, and its
    batch entry of meta.json ("symbolic" or the sorted fixed sizes)."""
    if batch_sizes is None:
        try:
            return {f"{stem}.pt2": _export(cfg, models, dev, None)}, \
                "symbolic"
        except Exception as e:      # tracing only: the writes come later
            print(f"[export] {dev.type}: symbolic-batch export failed "
                  f"({type(e).__name__}); exporting the fixed batch set "
                  f"{list(FALLBACK_BATCHES)} for {dev.type} instead: "
                  f"{str(e)[:300]}", flush=True)
            batch_sizes = FALLBACK_BATCHES
    sizes = sorted({int(n) for n in batch_sizes})
    if not sizes or sizes[0] < 1:
        raise ValueError(f"batch_sizes must be positive ints, got "
                         f"{batch_sizes!r}")
    return {f"{stem}_b{n}.pt2": _export(cfg, models, dev, n)
            for n in sizes}, sizes


def export_serving(cfg: Config, models: Models, out_dir: str,
                   batch_sizes: Optional[Sequence[int]] = None,
                   device: DeviceLike = None,
                   platforms: Optional[Sequence[str]] = None) -> str:
    """Trace the serving function of `models` (G, P, vgg in eval mode)
    and write the artifact into `out_dir`.  `platforms` (e.g. ["cuda",
    "cpu"]) traces one graph per device type, from models' weights
    wherever they are; None traces one on `device`, where the models must
    be.  `batch_sizes` None tries a symbolic batch first and falls back to
    FALLBACK_BATCHES, per platform; an explicit sequence exports that
    fixed set.  Returns `out_dir`."""
    cfg = cfg.replace(is_train=False, batch_size=1)
    if platforms is None:
        dev = resolve_device(device)
        graphs, batch = _trace(cfg, models, dev, batch_sizes, "serving")
        meta = {"format": 2, "device": dev.type, "batch": batch}
    else:
        meta = {"format": 3, "platforms": check_platforms(platforms),
                "batch": {}}
        graphs = {}
        for p in meta["platforms"]:
            g, meta["batch"][p] = _trace(cfg, models, resolve_device(p),
                                         batch_sizes, f"serving_{p}")
            graphs.update(g)
    os.makedirs(out_dir, exist_ok=True)
    for name, ep in graphs.items():
        torch.export.save(ep, os.path.join(out_dir, name))
    with open(os.path.join(out_dir, META_FILE), "w") as f:
        json.dump(meta, f)
    cfg.save(os.path.join(out_dir, CFG_FILE))
    for name, net in zip(NPZ_FILES, models):
        export_network_npz(net, os.path.join(out_dir, name))
    return out_dir


def _load_weights(cfg: Config, artifact_dir: str, dev: torch.device
                  ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The npz weights on `dev`, keyed as the graph takes them.  Each npz
    loads strictly into its network built on the meta device."""
    from ..convert.jax_bridge import load_flat
    with torch.device("meta"):
        nets = build_models(cfg)
    out = {}
    for name, npz, net in zip(NETS, NPZ_FILES, nets):
        with np.load(os.path.join(artifact_dir, npz)) as raw:
            load_flat(net, raw, assign=True)
        out[name] = {k: v.to(dev) for k, v in _weights(net).items()}
    return out


def _make_fixed_dispatch(calls):
    """Any-batch callable over a {batch_size: call} dict: pick the smallest
    exported size that fits, pad a short chunk by repeating its last row
    (a per-sample graph: pad rows cannot change real rows), chunk requests
    larger than the largest exported size."""
    sizes = sorted(calls)

    def call(G, P, vgg, image, mask, ref):
        image, mask, ref = (torch.as_tensor(x) for x in (image, mask, ref))
        n = image.shape[0]
        if n == 0:
            raise ValueError("empty batch: image has leading dimension 0")
        outs = []
        i = 0
        while i < n:
            b = next((x for x in sizes if x >= n - i), sizes[-1])
            take = min(n - i, b)

            def chunk(a):
                c = a[i:i + take]
                if take < b:
                    c = torch.cat([c, c[-1:].expand(b - take, *c.shape[1:])])
                return c

            out = calls[b](G, P, vgg, chunk(image), chunk(mask), chunk(ref))
            outs.append(out[:take])
            i += take
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    return call


def load_serving(artifact_dir: str, device: DeviceLike = None
                 ) -> SimpleNamespace:
    """Load an export_serving artifact onto `device` ("cuda" unless given
    "cpu"): the graph of its device type, which the artifact must hold.

    Returns a namespace with `.cfg`, `.G/.P/.vgg` (the weights on the
    device, as the graph takes them), `.batch` ("symbolic" or the exported
    size list), `.device`, `.exported` (the ExportedPrograms) and `.call`,
    (G, P, vgg, image_u8, mask_u8, ref_u8) -> uint8 on the device, for any
    request batch; inputs may be numpy arrays or tensors.
    """
    dev = resolve_device(device)
    meta_path = os.path.join(artifact_dir, META_FILE)
    if not os.path.exists(meta_path):
        raise FileNotFoundError(
            f"no serving artifact at [{artifact_dir}] (missing {META_FILE}); "
            "create one with export_serving or `_cli export`")
    with open(meta_path) as f:
        meta = json.load(f)
    if "platforms" in meta:
        if dev.type not in meta["platforms"]:
            raise ValueError(
                f"the artifact at [{artifact_dir}] holds graphs for the "
                f"platforms {meta['platforms']} and none for {dev.type!r}; "
                f"export it again with {dev.type!r} among its platforms")
        stem, batch = f"serving_{dev.type}", meta["batch"][dev.type]
    elif meta.get("device") != dev.type:
        raise ValueError(
            f"the artifact at [{artifact_dir}] was exported on device type "
            f"{meta.get('device')!r} and serves there only, not on "
            f"{dev.type!r}; export it again on {dev.type!r}")
    else:
        stem, batch = "serving", meta["batch"]
    cfg = Config.load(os.path.join(artifact_dir, CFG_FILE))
    weights = _load_weights(cfg, artifact_dir, dev)

    def runner(ep):
        fn = ep.module()

        @torch.inference_mode()
        def run(G, P, vgg, image, mask, ref):
            return fn(G, P, vgg, *(_as_tensor(x, dev)
                                   for x in (image, mask, ref)))
        return run

    if batch == "symbolic":
        exported = {"symbolic": torch.export.load(
            os.path.join(artifact_dir, f"{stem}.pt2"))}
        call = runner(exported["symbolic"])
    else:
        exported = {int(n): torch.export.load(
            os.path.join(artifact_dir, f"{stem}_b{n}.pt2")) for n in batch}
        call = _make_fixed_dispatch({n: runner(ep)
                                     for n, ep in exported.items()})
    return SimpleNamespace(cfg=cfg, batch=batch, device=dev,
                           exported=exported, call=call, **weights)
