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
    mask; and the refusals.  Writes what each gave."""
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
                    mine(inputs["x"])[:, :, :3])),
                ("int8", lambda: _under_modes(convs.ConvModes(int8=True),
                                              inputs)),
                ("pack", lambda: _under_modes(convs.ConvModes(
                    pack_small_cin=True, pack_out=True), inputs))):
            try:
                call()
                refusals[name] = None
            except (ValueError, NotImplementedError) as e:
                refusals[name] = f"{type(e).__name__}: {e}"
        out["refusals"] = refusals
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def _under_modes(modes, inputs):
    from deepinpainting_torch.ops import convs
    layer, x, _ = inputs["layers"]["conv_k3s1p1"]
    with convs.use_modes(modes):
        return layer(x[:, :, :4])


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
