"""The numbers read from what the timed path produced against what the
plain reference works out from the same weights and inputs.  A cell's
workload file gives a limit to those it compares (its `checks`); the rest
are logged.

Train cells (the first WARM_STEPS steps of the step object the window
then drives):
  loss.stepK.G        the relative gap of step K's generators' objective
                      (reference/step.py::losses_of); loss.stepK.DF the
                      discriminators'.  fake_B passes through the
                      attention's argmax: on seeds where a position's two
                      best patches match within the program's own
                      run-to-run rounding, the argmax flips between runs,
                      and DF (netD and netF on fake_B) jumps by up to
                      ~1e-3 while G, mostly L1, moves far less
  grad1.worst_leaf    over every trained leaf: |norm of the program's
                      first gradient (from its optimiser's state after
                      one step) - the reference's| over the larger of the
                      reference's norm of that leaf and of the median
                      leaf; grad1.worst_moved the same over the moved
                      leaves (below), grad1.median_leaf the median leaf's;
                      grad1.median_leaf.<net> the median over one network's
                      leaves.  netP's (.P) is the one no argmax reaches:
                      fake_P enters netG detached, so P's gradient is that
                      of its own L1 term alone
  delta3.worst_leaf   the same of each leaf's change over the first steps,
                      over the moved leaves: those whose first gradient in
                      the reference is at least a thousandth of the median
                      leaf's (a bias ahead of an instance norm has a
                      gradient of round-off, and Adam moves it by that
                      round-off's sign); delta3.median_leaf the median's
Serve cells (every answer served in the window to a seeded sample of the
pool's requests):
  u8.mean_levels      mean |program - reference| over all their pixels and
                      channels, in uint8 levels
  u8.worst_image      the largest such mean of a single answer
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

import numpy as np

from .reference.step import losses_of

SMALL_GRAD = 1e-3
NETS = ("G", "P", "D", "F")


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
               keys: Optional[List[str]] = None) -> Dict[str, float]:
    keys = list(ref) if keys is None else keys
    median = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30)
            for k in keys}


def moved_leaves(ref_grad1: Dict[str, float]) -> List[str]:
    median = statistics.median(ref_grad1.values())
    return [k for k, g in ref_grad1.items() if g >= SMALL_GRAD * median]


def train_numbers(prog: Dict, ref: Dict, gan_weight: float
                  ) -> Dict[str, float]:
    """prog/ref: {'losses': [step metrics], 'grad1': {leaf: norm},
    'delta3': {leaf: norm}}."""
    lp = losses_of(prog["losses"], gan_weight)
    lr = losses_of(ref["losses"], gan_weight)
    out = {}
    for k, (p, r) in enumerate(zip(lp, lr)):
        for n in r:
            out[f"loss.step{k + 1}.{n}"] = abs(p[n] - r[n]) / abs(r[n])
    moved = moved_leaves(ref["grad1"])
    g_all = _leaf_gaps(prog["grad1"], ref["grad1"])
    g_moved = _leaf_gaps(prog["grad1"], ref["grad1"], moved)
    d_moved = _leaf_gaps(prog["delta3"], ref["delta3"], moved)
    out["grad1.worst_leaf"] = max(g_all.values())
    out["grad1.worst_moved"] = max(g_moved.values())
    out["grad1.median_leaf"] = statistics.median(g_all.values())
    for net in NETS:
        out[f"grad1.median_leaf.{net}"] = statistics.median(
            v for k, v in g_all.items() if k.startswith(net + "."))
    out["delta3.worst_leaf"] = max(d_moved.values())
    out["delta3.median_leaf"] = statistics.median(d_moved.values())
    return out


def train_worst_leaves(prog: Dict, ref: Dict) -> Dict[str, str]:
    """The leaves that set the worst-leaf numbers (for the run's log)."""
    moved = moved_leaves(ref["grad1"])
    worst = lambda gaps: max(gaps, key=gaps.get)
    return {"grad1": worst(_leaf_gaps(prog["grad1"], ref["grad1"])),
            "grad1.moved": worst(_leaf_gaps(prog["grad1"], ref["grad1"],
                                            moved)),
            "delta3": worst(_leaf_gaps(prog["delta3"], ref["delta3"],
                                       moved))}


def _mean_levels(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a.astype(np.int16) - b.astype(np.int16)).mean())


def serve_numbers(answers: Dict[int, list], ref: Dict[int, np.ndarray]
                  ) -> Dict[str, float]:
    """answers: {pool index: [uint8 HxWx3 served]}; ref: {pool index:
    uint8 HxWx3}."""
    per_answer = [_mean_levels(a, ref[i]) for i, got in answers.items()
                  for a in got]
    if not per_answer:
        return {"u8.mean_levels": float("nan"),
                "u8.worst_image": float("nan")}
    return {"u8.mean_levels": float(np.mean(per_answer)),
            "u8.worst_image": float(np.max(per_answer))}


def serve_self_spread(answers: Dict[int, list]) -> float:
    """The program against itself: the largest mean |difference| between
    two answers it gave to the same request (in calls of other
    compositions), in levels."""
    return max((_mean_levels(a, got[0]) for got in answers.values()
                for a in got[1:]), default=0.0)
