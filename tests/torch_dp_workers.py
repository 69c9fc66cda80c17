"""The rank side of the multi-process tests (tests/test_torch_dp_*.py and
tests/test_torch_sp_*.py).

`run_ranks(fn, world, tmp, *args)` starts `world` spawned processes; each
joins a gloo group on the CPU through a file:// rendezvous under `tmp`
(no TCP port for parallel test workers to race for), runs
`fn(rank, world, tmp, *args)` and leaves the group.  The functions here
write what the test compares into `tmp` with torch.save.  This module
imports torch and the port only, so a rank starts without JAX.
"""

from __future__ import annotations

import multiprocessing
import os
import traceback

import numpy as np
import torch

TIMEOUT_S = 240


def _entry(fn, rank, world, tmp, args):
    torch.set_num_threads(1)
    from deepinpainting_torch.parallel.mesh import init_distributed
    try:
        init_distributed("cpu", coordinator=f"file://{tmp}/rendezvous",
                         num_processes=world, process_id=rank)
        fn(rank, world, tmp, *args)
    except BaseException:
        with open(os.path.join(tmp, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def run_ranks(fn, world, tmp, *args):
    """Run fn on `world` gloo ranks; raise with a rank's traceback if one
    failed or any is still running after TIMEOUT_S."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, str(tmp), args))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT_S)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [open(os.path.join(tmp, f)).read()
              for f in sorted(os.listdir(tmp)) if f.startswith("error")]
    if hung or errors or any(p.exitcode for p in procs):
        raise RuntimeError(f"ranks {hung} hung; exit codes "
                           f"{[p.exitcode for p in procs]}\n"
                           + "\n".join(errors))


def _state(cfg, sd):
    """A CPU TrainState of `cfg` holding the state_dict `sd`."""
    from deepinpainting_torch.engine import inpaint as TI
    state = TI.create_state(cfg, torch.Generator().manual_seed(5), "cpu")
    state.load_state_dict(sd)
    return state


def dp_step(rank, world, tmp, cfg):
    """One data-parallel step on the global batch of `tmp`/inputs.pt, this
    rank's rows only: writes the rows it held, the metrics, and every
    trained network's `.grad` and state_dict after the step."""
    from deepinpainting_torch.engine.state import TRAINED
    from deepinpainting_torch.parallel import mesh
    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    state = mesh.replicate_state(_state(cfg, inputs["state"]),
                                 mesh.default_group())
    step = mesh.make_dp_train_step(cfg, "cpu", mesh.default_group())
    local = mesh.shard_batch(inputs["batch"], rank, world, cfg.grad_accum)
    state, metrics = step(state, local)
    torch.save({
        "rows": len(local["image"]),
        "metrics": {k: float(v) for k, v in metrics.items()},
        "grads": {n: {k: p.grad.clone() for k, p in
                      getattr(state, n).named_parameters()}
                  for n in TRAINED},
        "after": {n: getattr(state, n).state_dict() for n in TRAINED},
    }, os.path.join(tmp, f"rank{rank}.pt"))


def dp_parts(rank, world, tmp):
    """The group-aware pieces alone, each rank on its rows of the global
    inputs in `tmp`/inputs.pt: ra_gan_loss's global means and gradients;
    BatchNorm's global moments in train mode, under frozen_running_stats,
    and in a checkpointed level whose backward (and so the recompute)
    runs in another thread; and replicate_state of states drawn from
    different seeds."""
    import threading

    from deepinpainting_torch.config import Config
    from deepinpainting_torch.engine import inpaint as TI
    from deepinpainting_torch.losses import ra_gan_loss
    from deepinpainting_torch.models.remat import checkpoint_level
    from deepinpainting_torch.ops.convs import (BatchNorm,
                                                frozen_running_stats)
    from deepinpainting_torch.parallel import collectives, mesh
    group = mesh.default_group()
    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    rows = mesh.row_index(mesh.process_batch_rows(4, rank, world))
    mine = lambda name: inputs[name][rows].clone().requires_grad_(True)
    out = {}

    def layer():
        bn = BatchNorm(inputs["x"].shape[1])
        bn.load_state_dict(inputs["bn"])
        return bn

    with collectives.use_group(group):
        fake, real = mine("fake"), mine("real")
        loss = ra_gan_loss(fake, real, True)
        loss.backward()
        out["gan"] = (float(loss.detach()), fake.grad, real.grad)

        bn, x = layer(), mine("x")
        y = bn(x)
        (y * inputs["w"][rows]).sum().backward()
        out["bn"] = (y.detach(), x.grad, dict(bn.state_dict()))
        with frozen_running_stats(bn):
            y = bn(inputs["x"][rows])
        out["frozen"] = (y.detach(), dict(bn.state_dict()))

        groups = []

        class Level(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.bn = layer()

            def forward(self, x):
                groups.append(collectives.current_group() is group)
                return self.bn(x)

        level, x = Level(), mine("x")
        y = checkpoint_level(level, level, x, None)
        t = threading.Thread(
            target=lambda: (y * inputs["w"][rows]).sum().backward())
        t.start()
        t.join(60)
        out["remat"] = (y.detach(), x.grad, dict(level.bn.state_dict()),
                        groups)

    cfg = Config(fine_size=64, ngf=8, ndf=8, vgg_width_scale=1 / 8,
                 norm="batch")
    state = TI.create_state(cfg, torch.Generator().manual_seed(rank), "cpu")
    for p in state.G.parameters():      # Adam moments of its own a rank
        p.grad = torch.full_like(p, rank + 1.0)
    state.opt_G.step()
    mesh.replicate_state(state, group)
    out["replicated"] = state.state_dict()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def dp_fit(rank, world, tmp, cfg, dirs):
    """A data-parallel Trainer.fit of `cfg` on the data `dirs`, then the
    restore of its checkpoint, a resume of one more epoch and evaluate()
    of the resumed state: writes the checkpoint writes this rank made,
    the validation losses it computed, whether the restore equals the
    rank's trained state bit for bit, the epochs each fit ran, and the
    per-image metrics."""
    from deepinpainting_torch.data import InpaintDataset, SelfRefDataset
    from deepinpainting_torch.engine import inpaint as TI
    from deepinpainting_torch.engine.evaluator import evaluate
    from deepinpainting_torch.engine.trainer import Trainer
    s = cfg.fine_size
    train_ds = InpaintDataset(dirs["img"], dirs["mask"], dirs["ref"], s,
                              seed=cfg.seed)
    valid_ds = InpaintDataset(dirs["val"], dirs["mask"], dirs["ref"], s,
                              seed=cfg.seed + 1)
    out = {"writes": 0, "valid": [], "epochs": []}

    def watched(tr):
        write, validate, epoch = tr.ckpt._write, tr.validate, tr.train_epoch

        def counted_write(*a):
            out["writes"] += 1
            return write(*a)

        def recorded_validate(state):
            out["valid"].append(validate(state))
            return out["valid"][-1]

        def recorded_epoch(state, e, total):
            out["epochs"].append(e)
            return epoch(state, e, total)

        tr.ckpt._write, tr.validate = counted_write, recorded_validate
        tr.train_epoch = recorded_epoch
        return tr

    tr = watched(Trainer(cfg, train_ds, valid_ds, device="cpu"))
    state = tr.fit()
    out["steps"] = state.step
    out["rows"] = tr._rows
    fresh = TI.create_state(cfg, torch.Generator().manual_seed(99), "cpu")
    tr.ckpt.restore(cfg.niter, fresh, "cpu")
    a, b = state.state_dict(), fresh.state_dict()
    same = a["step"] == b["step"]
    for n in ("G", "P", "D", "F", "vgg"):
        same &= all(torch.equal(v, b[n][k]) for k, v in a[n].items())
    for n in ("opt_G", "opt_P", "opt_D", "opt_F"):
        for s0, s1 in zip(a[n]["state"].values(), b[n]["state"].values()):
            same &= all(torch.equal(s0[k], s1[k]) for k in s0)
    out["restored_bit_for_bit"] = bool(same)

    cfg3 = cfg.replace(continue_train=True, which_epoch="latest",
                       niter=cfg.niter + 1)
    state = watched(Trainer(cfg3, train_ds, valid_ds, device="cpu")).fit()
    out["resumed_steps"] = state.step
    res = evaluate(cfg.replace(is_train=False), state,
                   SelfRefDataset(dirs["val"], dirs["mask"], s),
                   device="cpu", verbose=False, return_per_image=True)
    out["evaluate"] = res
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def make_images(root, n, size, seed):
    """`n` random PNG images of `size` px under `root`."""
    from PIL import Image
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (size, size, 3),
                                     dtype=np.uint8)).save(
            os.path.join(root, f"x{i}.png"))


# ---- spatial partitioning (tests/test_torch_sp_*.py) -----------------------

def _sp_context(rank, world):
    """The spatial context of a 1 x world grid: this rank's slab."""
    from deepinpainting_torch.parallel import collectives
    g = torch.distributed.group.WORLD
    return collectives.Spatial(g, rank, world, g)


def sp_parts(rank, world, tmp):
    """The spatial primitives and layers on this rank's slab of the whole
    inputs in `tmp`/inputs.pt (H is dim 2): every conv geometry, the
    gather and the slice, InstanceNorm and a train-mode BatchNorm, each
    forward and backward of sum(y * w); a checkpointed conv whose backward
    (and so the recompute) runs in another thread; the dropout's keep
    mask; the refusals; and a conv under int8 and one under the pack
    modes (modes_convs).  Writes what each gave."""
    import threading

    from deepinpainting_torch.models.remat import checkpoint_level
    from deepinpainting_torch.ops import convs
    from deepinpainting_torch.parallel import collectives as C
    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    sp = _sp_context(rank, world)
    mine = lambda t: C.slice_rows(t, rank, world).clone()
    out = {}

    def run(layer, x, w):
        x = mine(x).requires_grad_(True)
        y = layer(x)
        (y * mine(w)).sum().backward()
        return (y.detach(), x.grad,
                {k: p.grad for k, p in layer.named_parameters()},
                dict(layer.state_dict()))

    with C.use_spatial(sp):
        for name, (layer, x, w) in inputs["layers"].items():
            out[name] = run(layer, x, w)
        # gather: every rank reads the whole tensor with its own weight
        x = mine(inputs["x"]).requires_grad_(True)
        y = C.full_rows(x)
        (y * inputs["gather_w"][rank]).sum().backward()
        out["gather"] = (y.detach(), x.grad)
        # slice: each rank's rows of a tensor every rank holds
        xf = inputs["x"].clone().requires_grad_(True)
        y = C.own_rows(xf)
        (y * mine(inputs["w"])).sum().backward()
        out["slice"] = (y.detach(), xf.grad)
        # a checkpointed level whose recompute runs in autograd's thread
        seen = []
        conv = inputs["layers"]["conv_k3s1p1"][0]

        class Level(torch.nn.Module):
            def forward(self, t):
                seen.append(C.current_spatial() is not None)
                return conv(t)

        conv.zero_grad()
        x = mine(inputs["layers"]["conv_k3s1p1"][1]).requires_grad_(True)
        level = Level()
        y = checkpoint_level(level, level, x, None)
        w = mine(inputs["layers"]["conv_k3s1p1"][2])
        t = threading.Thread(target=lambda: (y * w).sum().backward())
        t.start()
        t.join(60)
        out["remat"] = (y.detach(), x.grad, seen)
        # dropout: the whole image's mask, this rank's rows
        drop = convs.Dropout(0.5).train()
        gen = torch.Generator().manual_seed(11)
        out["dropout"] = drop(torch.ones_like(mine(inputs["x"])), gen)
        refusals = {}
        for name, call in (
                ("halo", lambda: C.halo_exchange(mine(inputs["x"])[:, :, :2],
                                                 sp.group, rank, world, 3,
                                                 2)),
                ("odd", lambda: inputs["layers"]["conv_k4s2p1"][0](
                    mine(inputs["x"])[:, :, :3]))):
            try:
                call()
                refusals[name] = None
            except (ValueError, NotImplementedError) as e:
                refusals[name] = f"{type(e).__name__}: {e}"
        out["refusals"] = refusals
        for name, (modes, layer, x) in modes_convs().items():
            with torch.no_grad(), convs.use_modes(modes):
                out[name] = layer(mine(x))
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def modes_convs():
    """{mode: (ConvModes, conv, input)}: a k3 s1 p1 conv that int8 takes
    (Cin and Cout 16) and a k4 s2 p1 conv that pack_small_cin rewrites by
    space-to-depth (Cin 4), each with an input [2, C, 16, 10], from seed
    3."""
    from deepinpainting_torch.ops import convs
    g = torch.Generator().manual_seed(3)
    out = {}
    for name, modes, layer in (
            ("int8", convs.ConvModes(int8=True),
             convs.Conv2d(16, 16, 3, 1, 1)),
            ("pack", convs.ConvModes(pack_small_cin=True, pack_out=True),
             convs.Conv2d(4, 3, 4, 2, 1))):
        with torch.no_grad():
            for p in layer.parameters():
                p.copy_(0.5 * torch.randn(p.shape, generator=g))
        out[name] = (modes, layer, torch.randn(2, layer.in_channels, 16, 10,
                                               generator=g))
    return out


def sp_infer(rank, world, tmp, cfgs):
    """make_sp_inference_fn over the world, for each of `cfgs`, on this
    rank's slab of each request in `tmp`/inputs.pt, with the networks'
    state_dicts there: writes fake_B and fake_P (this rank's slabs) by
    config and request."""
    from deepinpainting_torch.engine import inpaint as TI
    from deepinpainting_torch.parallel import spatial
    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    models = TI.build_models(cfgs[0])
    for net, sd in zip(models, inputs["models"]):
        net.load_state_dict(sd)
        net.eval()
    grid = spatial.make_sp_group()
    outs = []
    for cfg in cfgs:
        infer = spatial.make_sp_inference_fn(cfg, "cpu", grid)
        outs.append([infer(*models, *(spatial.slab(req, grid)[k] for k in
                                      ("image", "mask", "ref")))
                     for req in inputs["requests"]])
    torch.save({"outs": outs, "grid": grid[:4]},
               os.path.join(tmp, f"rank{rank}.pt"))


def sp_step(rank, world, tmp, cfg, n_data):
    """One step of the n_data x (world / n_data) grid on this rank's part
    (place_spatial) of the global batch of `tmp`/inputs.pt: writes the
    rank's grid place, the metrics, and every trained network's `.grad`
    and state_dict after the step."""
    from deepinpainting_torch.engine.state import TRAINED
    from deepinpainting_torch.parallel import spatial
    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    state = _state(cfg, inputs["state"])
    grid = spatial.make_dp_sp_groups(n_data, world // n_data)
    step = spatial.make_dp_sp_train_step(cfg, "cpu", grid)
    local = spatial.place_spatial(inputs["batch"], grid, cfg.grad_accum)
    state, metrics = step(state, local)
    torch.save({
        "grid": grid[:4], "shape": tuple(local["image"].shape),
        "metrics": {k: float(v) for k, v in metrics.items()},
        "grads": {n: {k: p.grad.clone() for k, p in
                      getattr(state, n).named_parameters()}
                  for n in TRAINED},
        "after": {n: getattr(state, n).state_dict() for n in TRAINED},
    }, os.path.join(tmp, f"rank{rank}.pt"))


def sp_session(rank, world, tmp, cfg):
    """InferenceSession(sp=True) over the world: rank 0 answers the
    requests of `tmp`/inputs.pt and closes, every other rank follows until
    then.  Writes the answers (rank 0) and the calls each rank ran."""
    from deepinpainting_torch.engine import inpaint as TI
    from deepinpainting_torch.serve.app import InferenceSession
    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    models = TI.build_models(cfg)
    for net, sd in zip(models, inputs["models"]):
        net.load_state_dict(sd)
    if rank:            # a follower's own weights: rank 0's replace them
        for p in models.G.parameters():
            p.data.add_(1.0)
    sess = InferenceSession(cfg, state=TI.Models(*(n.eval() for n in models)),
                            sp=True, device="cpu")
    answers = []
    if rank == 0:
        answers = [sess.run(*r) for r in inputs["requests"]]
        sess.close()
    else:
        sess.follow()
    torch.save({"answers": answers, "calls": sess.calls,
                "grid": sess.grid[:4]}, os.path.join(tmp, f"rank{rank}.pt"))


# ---- int8 across ranks (tests/test_torch_dp_int8.py, _sp_knobs.py) --------

def _models(cfg, sds):
    """The port's G, P and VGG of `cfg` (CPU, eval) holding `sds`."""
    from deepinpainting_torch.engine import inpaint as TI
    models = TI.build_models(cfg)
    for net, sd in zip(models, sds):
        net.load_state_dict(sd)
    return TI.Models(*(net.eval() for net in models))


def dp_int8(rank, world, tmp, cfg, dirs):
    """int8 under data parallelism: evaluate() over the images of `dirs`,
    the data-parallel eval step on this rank's rows of each batch of
    `tmp`/inputs.pt, and all_reduce_max of a rank's own tensor.  Writes
    the per-image metrics, fake_B of the rank's rows and the maximum."""
    from deepinpainting_torch.data import SelfRefDataset
    from deepinpainting_torch.engine.evaluator import evaluate
    from deepinpainting_torch.parallel import collectives, mesh
    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    models = _models(cfg, inputs["models"])
    group = mesh.default_group()
    res = evaluate(cfg, models, SelfRefDataset(dirs["val"], dirs["mask"],
                                               cfg.fine_size),
                   device="cpu", verbose=False, return_per_image=True)
    step = mesh.make_dp_eval_step(cfg, "cpu", group)
    fake_B = [step(models, mesh.shard_batch(b, rank, world))["fake_B"]
              for b in inputs["batches"]]
    mine = inputs["max_in"][rank]
    got = collectives.all_reduce_max(mine, group)
    torch.save({"evaluate": res, "fake_B": fake_B, "max": got,
                "max_in_after": mine},
               os.path.join(tmp, f"rank{rank}.pt"))


REWRITES = ("_conv2d_space_to_depth", "_conv2d_tap_stack", "_conv2d_hpack2",
            "_deconv_dpack4")


def count_rewrites():
    """Count each pack rewrite's calls in this process (the routing looks
    them up by name): the live {name: calls} dict."""
    from deepinpainting_torch.ops import convs
    calls = {n: 0 for n in REWRITES}
    for n in REWRITES:
        def wrapped(*a, _n=n, _f=getattr(convs, n)):
            calls[_n] += 1
            return _f(*a)
        setattr(convs, n, wrapped)
    return calls


def record_int32():
    """Record every int8 conv's int32 sums and activation scale in this
    process (ops/quant.py dequantizes each conv's sums once): the live
    list of (sums, scale)."""
    from deepinpainting_torch.ops import quant
    seen = []
    dequantize = quant._dequantize

    def recorded(acc, sx, *a):
        seen.append((acc.clone(), sx.clone()))
        return dequantize(acc, sx, *a)
    quant._dequantize = recorded
    return seen


class lowered:
    """Set the pack gates' module constants of ops/convs.py for the block
    (the thresholds tests lower so that a 64 px image packs)."""

    def __init__(self, values):
        from deepinpainting_torch.ops import convs
        self.convs, self.values = convs, values

    def __enter__(self):
        self.saved = {k: getattr(self.convs, k) for k in self.values}
        for k, v in self.values.items():
            setattr(self.convs, k, v)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(self.convs, k, v)


def sp_knobs(rank, world, tmp):
    """The conv modes on this rank's slab (tests/test_torch_sp_knobs.py):
    each int8 geometry's output and int32 sums; each pack case's forward
    and backward of sum(y * w) and the rewrites it called; then
    make_sp_inference_fn of the packed config (its gates lowered) and of
    the int8 one on each request, with the rewrites the packed forward
    called and the int8 convs' scales.  Writes what each gave."""
    from deepinpainting_torch.ops import convs
    from deepinpainting_torch.parallel import collectives as C
    from deepinpainting_torch.parallel import spatial
    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    sp = _sp_context(rank, world)
    mine = lambda t: C.slice_rows(t, rank, world).clone()
    calls = count_rewrites()
    sums = record_int32()
    out = {"int8": {}, "pack": {}}
    with C.use_spatial(sp):
        for name, (layer, x) in inputs["int8"].items():
            sums.clear()
            with torch.no_grad(), convs.use_modes(convs.ConvModes(int8=True)):
                y = layer(mine(x))
            out["int8"][name] = (y, *sums[0])
        for name, (layer, x, w) in inputs["pack"].items():
            for k in calls:
                calls[k] = 0
            xs = mine(x).requires_grad_(True)
            with convs.use_modes(convs.ConvModes(pack_small_cin=True,
                                                 pack_out=True)):
                y = layer(xs)
            (y * mine(w)).sum().backward()
            out["pack"][name] = (y.detach(), xs.grad,
                                 {k: p.grad for k, p in
                                  layer.named_parameters()}, dict(calls))
    models = _models(inputs["cfgs"]["int8"], inputs["models"])
    grid = spatial.make_sp_group()
    out["infer"] = {}
    for name, cfg in inputs["cfgs"].items():
        for k in calls:
            calls[k] = 0
        sums.clear()
        infer = spatial.make_sp_inference_fn(cfg, "cpu", grid)
        with lowered(inputs["lowered"] if name == "pack" else {}):
            outs = [infer(*models, *(spatial.slab(req, grid)[k] for k in
                                     ("image", "mask", "ref")))
                    for req in inputs["requests"]]
        out["infer"][name] = (outs, dict(calls), [s for _, s in sums])
    out["int8_variants"] = _int8_variants(inputs, models, grid)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def _int8_variants(inputs, models, grid):
    """make_sp_inference_fn of the int8 config on each request list of
    inputs["int8_variants"] (the requests, their images an ulp away), with
    the scales all-reduced ("global") and, as a control, each slab's own
    maximum as its scale ("slab"): {mode: [[(fake_B, fake_P)] a list]}."""
    from deepinpainting_torch.ops import quant
    from deepinpainting_torch.parallel import spatial
    infer = spatial.make_sp_inference_fn(inputs["cfgs"]["int8"], "cpu", grid)
    real, out = quant.all_reduce_max, {}
    try:
        for mode in ("global", "slab"):
            quant.all_reduce_max = (real if mode == "global" else
                                    lambda x, group: x.detach().clone())
            out[mode] = [[infer(*models, *(spatial.slab(req, grid)[k]
                                           for k in ("image", "mask", "ref")))
                          for req in reqs]
                         for reqs in inputs["int8_variants"]]
    finally:
        quant.all_reduce_max = real
    return out


def sp_step_lowered(rank, world, tmp, cfg, n_data, values):
    """sp_step with the pack gates lowered (`lowered`)."""
    with lowered(values):
        sp_step(rank, world, tmp, cfg, n_data)
