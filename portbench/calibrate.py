#!/usr/bin/env python3
"""Readings that the limits of a cell's correctness check are set from
(the benchmark's own runs do not run this).

    python3 portbench/calibrate.py --workload <cell> --seeds 12 \
        --controls 3 --seconds 3 --out build/portbench/cal/<cell>.json

For each seed, in one process: the program's numbers against the plain
reference, as a run of the cell reads them (train: the step object's first
steps; serve: the answers of a `--seconds` window at the cell's own load).
For the first `--controls` seeds also the control, the reference put in
the program's place one precision below the configuration's (the family's
`control`; IPSR's, f32: TF32 convolutions and matmuls; bf16: float8 e4m3
conv operands), and for train cells the fault of half the batch left out (the reference on the first
half of each batch) and the program against itself (a second step object
from the same seed).  A step that returns its state unchanged reads 1 on
delta3 by construction and needs no run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _program_readings(cell, cfg, seed, dev):
    from portbench import harness
    s = harness.train_setup(cell, cfg, seed, dev)
    harness.close_feed(s)
    s.state = s.step = s.feed = None
    harness._free()
    return s


def train_seed(cell, cfg, seed, dev, with_control: bool) -> dict:
    from portbench import harness
    s = _program_readings(cell, cfg, seed, dev)
    fam = s.family
    program = s.readings
    ref = harness.train_reference(s)
    out = {"program": fam.train_numbers(program, ref, cfg),
           "note": fam.train_note(program, ref),
           "losses": [program["losses"], ref["losses"]]}
    if with_control:
        ctx, prec = fam.control(cfg)
        with ctx:
            ctrl = harness.train_reference(s, prec)
        out["control"] = fam.train_numbers(ctrl, ref, cfg)
        half = harness.train_reference(s, half=True)
        out["half_batch"] = fam.train_numbers(half, ref, cfg)
        # the program against itself: a second step object from the seed
        again = _program_readings(cell, cfg, seed, dev).readings
        out["repeat"] = fam.train_numbers(again, program, cfg)
    return out


def serve_seed(cell, cfg, seed, dev, seconds, with_control: bool) -> dict:
    from portbench import harness
    s = harness.serve_setup(cell, cfg, seed, dev)
    fam = s.family
    _, answers, _ = harness.serve_window(s, cell.traffic, seed, seconds,
                                         False)
    s.session.close()
    s.session = None
    harness._free()
    ref = harness.serve_reference(s, answers)
    out = {"program": fam.serve_numbers(answers, ref),
           "note": fam.serve_note(answers),
           "answers": sum(len(v) for v in answers.values())}
    if with_control:
        ctx, prec = fam.control(cfg)
        with ctx:
            ctrl = harness.serve_reference(s, answers, prec)
        out["control"] = fam.serve_numbers({i: [ctrl[i]] for i in ctrl}, ref)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from deepinpainting_torch.device import resolve_device
    from portbench import harness
    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    dev = resolve_device("cuda")
    cfg = harness.program_config(cell)
    rows = []
    for k in range(args.seeds):
        seed = args.first_seed + 7919 * k
        t = time.perf_counter()
        if cell.traffic["kind"] == "train":
            row = train_seed(cell, cfg, seed, dev, k < args.controls)
        else:
            row = serve_seed(cell, cfg, seed, dev, args.seconds,
                             k < args.controls)
        row.update(seed=seed, seconds=time.perf_counter() - t)
        rows.append(row)
        print(json.dumps(row), flush=True)
        harness._free()
    summary = {}
    for part in ("program", "repeat", "control", "half_batch"):
        got = [r[part] for r in rows if part in r]
        if got:
            pick = max if part in ("program", "repeat") else min
            summary[part] = {k: pick(g[k] for g in got) for k in got[0]}
    out = {"workload": args.workload, "card": torch.cuda.get_device_name(),
           "rows": rows, "summary": summary}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print("summary", json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
