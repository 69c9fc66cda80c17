"""The trajectory figures PERF.md quotes, at the tiny configuration on the
CPU (tests/torch_trajectory.py's machinery):

  * `scan`: for each protocol and starting draw, the largest ratio over
    --steps steps of the port's departure from JAX to 8x JAX's own
    four-nudge envelope (every loss and every network's parameters), and
    the same for the control (every Adam one step ahead);
  * `jumps`: at JAX's own init_params at seed 0, `corrected`, batch seed
    0: the largest change of G's and D's first gradients under each of
    --nudges one-ulp nudges of JAX's weights (the discrete event of
    tests/test_torch_trajectory_events.py).

    python studies/trajectory_scan.py scan --steps 16 --draws 0,1
    python studies/trajectory_scan.py jumps --nudges 16
"""

from __future__ import annotations

import argparse
import os
import sys

import common
PROTOCOLS = {
    "faithful": {},
    "corrected": dict(faithful_backward_truncation=False,
                      faithful_detached_cosis=False),
    "trunc": dict(faithful_backward_truncation=False),
    "cosis": dict(faithful_detached_cosis=False),
    "kr": dict(faithful_known_replacement=False),
}
BASE = dict(batch_size=2, mask_type="random", attention_impl="lax")


def scan(steps: int, draws, names) -> None:
    import torch_trajectory as TT
    for name in names:
        fields = dict(BASE, **PROTOCOLS[name])
        for seed in draws:
            tr = TT.trajectory(fields, steps, seed=seed, batch_seed=0,
                               ports={"port": {},
                                      "control": {"adam_count": 1}})
            ex = TT.excess(tr["ports"]["port"], tr)
            exc = TT.excess(tr["ports"]["control"], tr)
            print(f"{name} draw {seed}: port {max(ex.values()):.3f} of the "
                  f"limit (worst {max(ex, key=ex.get)}), control "
                  f"{max(exc.values()):.2f}", flush=True)


def jumps(nudges: int) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch_trajectory as TT
    from deepinpainting_tpu.engine import inpaint as JI
    from deepinpainting_tpu.engine import state as JST
    from torch_port_helpers import configs, flat_of
    jcfg, _ = configs(**dict(BASE, **PROTOCOLS["corrected"]))
    params = TT.draw(jcfg, 0, jax_init=True)
    batch = TT.synth_batches(1, 2, 64, 0)[0]
    step = jax.jit(JI.make_train_step(jcfg))

    def grads(p):
        s1, _ = step(JST.create_train_state(jcfg, p),
                     {k: jnp.asarray(v) for k, v in batch.items()},
                     jax.random.PRNGKey(0))
        # Adam's first moment after one step is (1 - beta1) * g
        return {n: {k: v / (1 - jcfg.beta1) for k, v in flat_of(
            getattr(s1, f"opt_{n}").inner_state[0].mu).items()}
            for n in ("G", "D")}
    ref = grads(params)
    for i in range(nudges):
        g = grads(dict(params, **{n: TT.nudge(params[n], i)
                                  for n in TT.TRAINED}))
        jump = {n: max(float(np.abs(g[n][k] - ref[n][k]).max())
                       for k in ref[n]) for n in ref}
        print(f"nudge {i}: " + ", ".join(f"{n} {v:.3g}"
                                         for n, v in jump.items()),
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("scan", "jumps"))
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--draws", default="0,1")
    ap.add_argument("--protocols", default=",".join(PROTOCOLS))
    ap.add_argument("--nudges", type=int, default=16)
    args = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(common.TESTS))
    if args.what == "scan":
        scan(args.steps, [int(s) for s in args.draws.split(",")],
             args.protocols.split(","))
    else:
        jumps(args.nudges)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
