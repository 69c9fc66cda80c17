#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card of this machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The last line of standard output is one JSON
object: correct, attempted, failed, metrics (the cell's end-to-end metrics,
or with --trace 1 its per-layer ones), device, with --trace 1 breakdown,
and last `checks`, each number compared with its limit; the same numbers
are the last lines of standard error.  With no card, or fewer cards than
the cell asks for, or with JAX or the JAX package loaded in the process
once the window has closed, it prints no result and exits non-zero.

Every cache the run writes (the kernels' nvcc libraries, PyTorch's and
Triton's kernel caches) stays under build/ in the checkout, at fixed
paths.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench" / "cache"
for _var, _sub in (("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(CACHE / _sub)
os.environ["USE_FLAX"] = "0"


def process_start() -> float:
    """The wall-clock time this process started (/proc), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


STARTED = process_start()


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from portbench import harness
    cell = harness.load_cell(args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"[portbench] {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {found}", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", STARTED)
    loaded = harness.forbidden_modules(sys.modules)
    if loaded:
        print(f"[portbench] the process loaded {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"[portbench] check {name} = {c['value']!r} (limit "
              f"{c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
