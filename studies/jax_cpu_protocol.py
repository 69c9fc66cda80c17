"""The `f32` protocol (128 px, batch 8, 10 + 10 epochs) in full f32 on the
CPU, in both packages, at a narrower width than the recorded runs:
ngf = ndf = NGF and VGG at NGF/64 of its width.  On the CPU both packages
compute in full f32 and every run is deterministic, so a seed is one
draw of the outcome.

  * `jax`: the JAX package's own trainer and evaluation
    (scripts/train.py --cpu, scripts/evaluate.py --cpu, attention 'lax'),
    on the same synthetic data (deepinpainting_torch/data/synth.py, byte
    for byte the data make_synth_data.py writes);
  * `pair`: both packages from the same starting weights on the same
    batch stream for --steps steps, with JAX's own envelope over four
    one-ulp nudges (tests/torch_trajectory.py), per step;
  * `init` / `portinit`: the JAX trainer's / the port's starting weights
    at a seed to <out>/jax_init/s<seed>/<net>.npz / <out>/port_init/...
    (flat JAX dicts; studies/protocol_spread.py --init_from reads them);
  * `jaxfrom` / `portfrom`: the JAX package's trainer / the port's
    protocol on the CPU from the weights under --init_root/s<seed>/
    (DRAWS: e.g. a `portinit` export made on the card's machine).

    python studies/jax_cpu_protocol.py --out build/jaxcpu --ngf 16 \
        --run jax:0-3 --run pair:0 --steps 74
    python studies/jax_cpu_protocol.py --out build/jaxcpu --ngf 16 \
        --run jaxfrom:1 --run portfrom:1 --init_root DRAWS

Results go to <out>/results/<kind>_s<seed>.json and are printed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import common
from common import REPO


def width(ngf: int) -> tuple:
    return ("--ngf", str(ngf), "--ndf", str(ngf), "--vgg_width_scale",
            str(ngf / 64))


# JAX's trainer from the flat .npz files of a directory: its create_state
# (as the trainer module bound it) draws the trees, which are then filled
_FROM_FILES = """
import sys
import jax
from deepinpainting_tpu import _cli
from deepinpainting_tpu.engine import trainer as T
from deepinpainting_tpu.engine.checkpoint import import_network_npz
from deepinpainting_tpu.engine.inpaint import init_params
from deepinpainting_tpu.engine.state import create_train_state
root = sys.argv[1]
def create_state(cfg, rng):
    p = dict(init_params(cfg, rng))
    for net in ("G", "P", "D", "F", "vgg"):
        p[net] = import_network_npz(p[net], f"{root}/{net}.npz")
    print(f"[jaxfrom] starting weights from {root}", flush=True)
    return create_train_state(cfg, p)
T.create_state = create_state
_cli.train(sys.argv[2:])
"""


def port_init(out: Path, ngf: int, seed: int) -> dict:
    """The port's starting weights of the protocol at `seed` (create_state
    from torch.Generator().manual_seed(seed), as its Trainer draws them)
    as flat JAX dicts under <out>/port_init/s<seed>/<net>.npz.  The draw
    of VGG (and so of D and F after it) follows torch's trunc_normal_,
    which differs between torch versions: export it where it trains."""
    import numpy as np
    import torch

    from deepinpainting_torch import demo
    from deepinpainting_torch.convert.jax_bridge import flat_dict
    from deepinpainting_torch.engine.inpaint import create_state
    cfg = demo.train_config(list(demo.COMMON) + list(width(ngf))).replace(
        seed=seed)
    state = create_state(cfg, torch.Generator().manual_seed(seed), "cpu")
    root = out / "port_init" / f"s{seed}"
    root.mkdir(parents=True, exist_ok=True)
    for net in ("G", "P", "D", "F", "vgg"):
        np.savez(root / f"{net}.npz", **flat_dict(getattr(state, net)))
    return {"kind": "portinit", "seed": seed, "ngf": ngf,
            "torch": torch.__version__}


def jax_run(out: Path, data: Path, ngf: int, seed: int,
            short: bool = False, init_root: Path = None) -> dict:
    """`short`: 1 + 1 epochs, evaluated at epochs 1 and 2 (a rehearsal);
    `init_root`: from the weights under init_root/s<seed>/ instead of
    JAX's own draw."""
    from deepinpainting_torch import demo
    ckpt = out / "jax_ckpt"
    name = f"jaxfrom_s{seed}" if init_root else f"jax_s{seed}"
    epochs = (1, 2) if short else (5, 20)
    cut = (("--niter", "1", "--niter_decay", "1", "--save_epoch_freq", "1")
           if short else ())
    common = ["--dataroot", str(data / "img"), "--maskroot",
              str(data / "mask"), "--refroot", str(data / "img"),
              "--validroot", str(data / "valid"), "--validrefroot",
              str(data / "valid"), *demo.COMMON, *width(ngf),
              "--attention_impl", "lax", "--seed", str(seed),
              "--checkpoints_dir", str(ckpt), "--name", name, *cut]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    logs = out / "logs"
    logs.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    if init_root:
        cmd = [sys.executable, "-c", _FROM_FILES,
               str(init_root / f"s{seed}"), "--cpu", *common]
        env["PYTHONPATH"] = str(REPO)
    else:
        cmd = [sys.executable, str(REPO / "scripts" / "train.py"), "--cpu",
               *common]
    with open(logs / f"{name}.train.log", "w") as log:
        subprocess.run(cmd, env=env, stdout=log, stderr=subprocess.STDOUT,
                       check=True)
    if init_root and "[jaxfrom] starting weights" not in (
            logs / f"{name}.train.log").read_text():
        raise RuntimeError(f"{name}: JAX's trainer drew its own weights")
    fig = {"kind": "jaxfrom" if init_root else "jax", "seed": seed,
           "init_root": str(init_root or ""), "ngf": ngf,
           "train_s": time.perf_counter() - t0}
    for ep, tag in zip(epochs, (5, 20)):
        res = subprocess.run(
            [sys.executable, str(REPO / "scripts" / "evaluate.py"), "--cpu",
             "--dataroot", str(data / "valid"), "--maskroot",
             str(data / "mask"), "--checkpoints_dir", str(ckpt), "--name",
             name, "--which_epoch", str(ep), "--max_images", "32"],
            env=env, capture_output=True, text=True, check=True)
        (logs / f"{name}.eval_e{ep}.log").write_text(res.stdout)
        psnr = demo.per_image(res.stdout)
        fig[f"psnr_e{tag}"] = sum(psnr[0]) / len(psnr[0])
        fig[f"ssim_e{tag}"] = sum(psnr[1]) / len(psnr[1])
    fig["epoch_train_valid"] = common.train_valid(
        (logs / f"{name}.train.log").read_text())
    return fig


def jax_init(out: Path, ngf: int, seed: int) -> dict:
    import jax
    import numpy as np
    jax.config.update("jax_platforms", "cpu")
    from deepinpainting_tpu.config import Config
    from deepinpainting_tpu.engine.checkpoint import export_network_npz
    from deepinpainting_tpu.engine.inpaint import init_params
    cfg = Config(fine_size=128, batch_size=8, ngf=ngf, ndf=ngf,
                 vgg_width_scale=ngf / 64, attention_impl="lax", seed=seed)
    params = init_params(cfg, jax.random.PRNGKey(seed))
    root = out / "jax_init" / f"s{seed}"
    for net in ("G", "P", "D", "F", "vgg"):
        export_network_npz(params[net], str(root / f"{net}.npz"))
    return {"kind": "init", "seed": seed, "ngf": ngf, "params": int(sum(
        np.asarray(x).size for x in jax.tree_util.tree_leaves(params)))}


def port_run(out: Path, ngf: int, seed: int, init_root: Path) -> dict:
    """The port's protocol (demo.run_protocol) on the CPU from the weights
    under init_root/s<seed>/."""
    from deepinpainting_torch import demo
    common.start_from(init_root)
    base = demo.PROTOCOLS["f32"]
    proto = dataclasses.replace(
        base, name="portfrom", serve=False,
        overrides=width(ngf),
        evaluations=tuple(ev for ev in base.evaluations
                          if ev.name in ("e5", "e20")))
    fig = demo.run_protocol(proto, out, seed, "cpu")
    fig["epoch_train_valid"] = common.train_valid(
        (out / "logs" / f"{proto.name}_seed{seed}.train0.log").read_text())
    return dict(fig, kind=proto.name, ngf=ngf)


def pair_run(ngf: int, seed: int, steps: int) -> dict:
    """Both packages from the same weights on the same stream; JAX's own
    four-nudge envelope; per step the departures and their ratio to 8x
    the envelope."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(common.TESTS))
    import numpy as np
    import torch_trajectory as TT
    fields = dict(fine_size=128, batch_size=8, ngf=ngf, ndf=ngf,
                  vgg_width_scale=ngf / 64, mask_type="random",
                  attention_impl="lax")
    t0 = time.perf_counter()
    tr = TT.trajectory(fields, steps, seed=seed, batch_seed=seed)
    port = TT.port_run(fields, tr["params"], tr["batches"])
    dep = TT.departures(port, tr["ref"])
    lim = TT.limits(tr)
    ratio = {k: (np.asarray(dep[k]) / lim[k]).tolist() for k in lim}
    first = {k: next((i + 1 for i, r in enumerate(v) if r > 1.0), None)
             for k, v in ratio.items()}
    return {"kind": "pair", "seed": seed, "ngf": ngf, "steps": steps,
            "seconds": time.perf_counter() - t0,
            "jax_losses": tr["ref"]["losses"],
            "port_losses": port["losses"],
            "departure": {k: list(map(float, dep[k])) for k in lim},
            "envelope": {k: list(map(float, v))
                         for k, v in tr["envelope"].items()},
            "ratio_to_limit": ratio, "first_step_out": first}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--ngf", type=int, default=16)
    ap.add_argument("--run", action="append", default=[],
                    help="jax, pair, init, portinit, jaxfrom or "
                         "portfrom:SEEDS (a-b or a,b)")
    ap.add_argument("--init_root", default="",
                    help="jaxfrom / portfrom: the weights under "
                         "INIT_ROOT/s<seed>/<net>.npz")
    ap.add_argument("--steps", type=int, default=74)
    ap.add_argument("--short", action="store_true",
                    help="jax runs of 1 + 1 epochs (a rehearsal)")
    args = ap.parse_args(argv)
    out = Path(args.out).resolve()
    (out / "results").mkdir(parents=True, exist_ok=True)
    from deepinpainting_torch import demo
    data, _ = demo.make_data(out, demo.DATA["synth"])
    for spec in args.run:
        kind, seeds = spec.split(":")
        for seed in common.seeds(seeds):
            t0 = time.perf_counter()
            root = Path(args.init_root).resolve() if args.init_root \
                else None
            if kind == "jax":
                fig = jax_run(out, data, args.ngf, seed, args.short)
            elif kind == "jaxfrom":
                fig = jax_run(out, data, args.ngf, seed, args.short, root)
            elif kind == "portfrom":
                fig = port_run(out, args.ngf, seed, root)
            elif kind == "pair":
                fig = pair_run(args.ngf, seed, args.steps)
            elif kind == "init":
                fig = jax_init(out, args.ngf, seed)
            elif kind == "portinit":
                fig = port_init(out, args.ngf, seed)
            else:
                raise ValueError(kind)
            fig["wall_s"] = time.perf_counter() - t0
            (out / "results" / f"{kind}_s{seed}.json").write_text(
                json.dumps(fig))
            short = {k: v for k, v in fig.items()
                     if k.startswith(("psnr", "ssim", "first", "wall",
                                      "train_s"))}
            print(f"[jaxcpu] {kind} seed {seed}: {short}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
