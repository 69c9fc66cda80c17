"""What the study scripts share: the repository on sys.path (each script
imports this module first), seed lists, the trainer's epoch log, the
per-epoch means of a run's per-step losses, and a Trainer that starts
from weights on disk."""

from __future__ import annotations

import csv
import re
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
TESTS = REPO / "tests"
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
LOSSES = ("D", "F", "G_GAN", "G_L1", "cosis")
EPOCH_STEPS = 37        # the 128 px protocols: 300 images, batches of 8


def seeds(text: str) -> list:
    """'a-b' (a..b) or 'a,b,...' -> a list of ints."""
    if "-" in text:
        lo, hi = map(int, text.split("-"))
        return list(range(lo, hi + 1))
    return [int(s) for s in text.split(",")]


def train_valid(log_text: str) -> list:
    """[[train loss, valid loss]] for each epoch of a trainer's log (both
    packages' trainers print the same line)."""
    return [[float(a), float(b)] for a, b in re.findall(
        r"Train loss : (\S+), Valid loss : (\S+)", log_text)]


def epoch_means(metrics_csv: Path, per: int, keys=LOSSES) -> dict:
    """{loss: [mean of each epoch's `per` steps]} from a run's
    metrics.csv."""
    with open(metrics_csv) as f:
        rows = list(csv.DictReader(f))
    return {k: [sum(float(r[k]) for r in rows[e * per:(e + 1) * per]) / per
                for e in range(len(rows) // per)] for k in keys}


def start_from(root: Path) -> None:
    """Every Trainer of this process starts from the weights under
    root/s<seed>/{G,P,D,F,vgg}.npz (flat JAX dicts, e.g. the JAX
    package's own init_params, written by studies/jax_cpu_protocol.py
    --run init:SEED or studies/jax_draw.py unpack) instead of the port's
    draw of its seed."""
    import numpy as np

    from deepinpainting_torch.convert.jax_bridge import load_flat
    from deepinpainting_torch.engine import trainer as TR
    init_state = TR.Trainer.init_state

    def from_files(self, generator=None):
        state = init_state(self, generator)
        for net in ("G", "P", "D", "F", "vgg"):
            with np.load(root / f"s{self.cfg.seed}" / f"{net}.npz") as f:
                load_flat(getattr(state, net), f)
        return state
    TR.Trainer.init_state = from_files
