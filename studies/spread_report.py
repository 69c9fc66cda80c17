"""The figures of a protocol spread (studies/protocol_spread.py's summary
and per-step metrics) that PERF.md quotes:

  * each mode's runs, e20 PSNR sorted, and how many end below --cut dB
    (the lower group);
  * a seed's repeats: same group or not, and bit-for-bit equal or not;
  * per epoch and per loss (D, F, G_GAN, G_L1, cosis), the two groups'
    ranges of the epoch's mean over all runs of the modes named, the
    first epoch at which they part with no overlap, and each group's mean
    against the JAX package's recorded run (artifacts/train_demo/
    metrics.csv, the same protocol at seed 0 on a TPU).

    python studies/spread_report.py build/spread [--cut 27.5]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from common import LOSSES, REPO, epoch_means

STEPS_PER_EPOCH = 37


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", help="a spread's output (summary.json, logs/)")
    ap.add_argument("--cut", type=float, default=27.5)
    ap.add_argument("--modes", default="f32,det",
                    help="modes whose runs the epoch table pools")
    args = ap.parse_args(argv)
    root = Path(args.root)
    summary = json.loads((root / "summary.json").read_text())
    runs = summary["runs"]
    by_mode = {}
    for r in runs:
        by_mode.setdefault(r["mode"], []).append(r)
    from scipy.stats import fisher_exact
    print("mode  n  below-cut  e20 PSNR sorted  (Fisher's exact p of the "
          "below-cut count against f32's, two-sided)")
    counts = {}
    for mode, rs in by_mode.items():
        ps = sorted(r["psnr_e20"] for r in rs)
        counts[mode] = (sum(p < args.cut for p in ps), len(ps))
    for mode, rs in by_mode.items():
        ps = sorted(r["psnr_e20"] for r in rs)
        low, n = counts[mode]
        p = ""
        if "f32" in counts and mode != "f32":
            lo32, n32 = counts["f32"]
            odds = fisher_exact([[low, n - low], [lo32, n32 - lo32]])
            p = f"  p = {odds[1]:.3f}"
        print(f"{mode:5s} {n:2d}  {low:2d}  "
              + " ".join(f"{x:.4f}" for x in ps) + p)
    print("\nrepeats of a seed: e20 PSNRs, same group, bit for bit")
    for mode, rs in by_mode.items():
        seeds = {}
        for r in rs:
            seeds.setdefault(r["seed"], []).append(r["psnr_e20"])
        for seed, ps in sorted(seeds.items()):
            if len(ps) > 1:
                same = len({p < args.cut for p in ps}) == 1
                bits = summary["bit_equal_repeats"].get(f"{mode}_s{seed}")
                print(f"  {mode} seed {seed}: "
                      + ", ".join(f"{p:.4f}" for p in ps)
                      + f"; same group {same}; bit for bit {bits}")

    pooled = [r for r in runs if r["mode"] in args.modes.split(",")]
    curves = {(r["mode"], r["seed"], r["rep"]): epoch_means(
        root / "logs" / f"{r['mode']}r{r['rep']}_seed{r['seed']}"
        ".metrics.csv", STEPS_PER_EPOCH) for r in pooled}
    low = [k for k, r in zip(curves, pooled) if r["psnr_e20"] < args.cut]
    high = [k for k, r in zip(curves, pooled) if r["psnr_e20"] >= args.cut]
    jax = epoch_means(REPO / "artifacts" / "train_demo" / "metrics.csv",
                      STEPS_PER_EPOCH)
    print(f"\nepoch means over {len(high)} upper and {len(low)} lower runs "
          f"({args.modes}); 'parts' = no overlap; JAX's recorded run")
    for k in LOSSES:
        first = None
        print(f"  {k}:")
        for e in range(len(jax[k])):
            hi = [curves[c][k][e] for c in high]
            lo = [curves[c][k][e] for c in low]
            parts = max(hi) < min(lo) or max(lo) < min(hi)
            if parts and first is None:
                first = e + 1
            if e < 6 or e % 5 == 4:
                print(f"    epoch {e + 1:2d}: upper {min(hi):8.3f}-"
                      f"{max(hi):8.3f} (mean {sum(hi) / len(hi):8.3f}), "
                      f"lower {min(lo):8.3f}-{max(lo):8.3f} (mean "
                      f"{sum(lo) / len(lo):8.3f}), JAX {jax[k][e]:8.3f}"
                      + ("  parts" if parts else ""))
        print(f"    first epoch parting with no overlap: {first}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
