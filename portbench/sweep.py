#!/usr/bin/env python3
"""Find the highest offered rate an open-loop serving cell sustains, by a
sweep on the card (the benchmark's own runs do not run this).

    python3 portbench/sweep.py --workload serve-256-f32-sat \
        --rates 70,90,100,110,120,125,130,140 --seconds 10 --senders 32

One session (the serving cell's, from --seed) serves each rate in turn on
an open-loop schedule (drivers.open_loop, sent by --senders threads).  A
rate is sustained when the answers keep up with the offer (completed a
second >= 97% of the rate) and no backlog grows through the window (the
mean latency of the last quarter of the answers is under 1.5 times that
of the first quarter).  An open-loop
cell's rate is set at about four fifths of the highest rate sustained.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=4_000_000_007)
    ap.add_argument("--senders", type=int, default=32)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from deepinpainting_torch.device import resolve_device
    from portbench import harness
    if not torch.cuda.is_available():
        print("sweep.py needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    dev = resolve_device("cuda")
    s = harness.serve_setup(cell, harness.program_config(cell), args.seed,
                            dev)
    rows = []
    for rate in (float(r) for r in args.rates.split(",")):
        traffic = dict(cell.traffic, kind="open", rate=rate,
                       senders=args.senders)
        w, _, late = harness.serve_window(s, traffic, args.seed, args.seconds,
                                          False)
        row = {"rate": rate, **_reading(w, rate),
               "late_p99_ms": float(np.percentile(late, 99) * 1e3),
               "occupancy": w.counters["items_served"]
               / max(1, w.counters["batches_run"])}
        rows.append(row)
        print(json.dumps(row), flush=True)
    s.session.close()
    best = max((r["rate"] for r in rows if r["sustained"]), default=None)
    print(json.dumps({"knee": best, "card": torch.cuda.get_device_name()}))
    return 0


def _reading(w, rate):
    """Completed a second, latency percentiles, and the growth of the mean
    latency from the first quarter of the answers to the last."""
    lat = np.asarray(w.latencies)
    q = max(1, len(lat) // 4)
    completed = w.images / w.seconds if w.seconds > 0 else 0.0
    growth = lat[-q:].mean() / max(lat[:q].mean(), 1e-9)
    return {"completed_per_s": completed,
            "p50_ms": float(np.percentile(lat, 50) * 1e3),
            "p95_ms": float(np.percentile(lat, 95) * 1e3),
            "growth": float(growth),
            "sustained": bool(completed >= 0.97 * rate and growth < 1.5)}


if __name__ == "__main__":
    sys.exit(main())
