"""Screen batch seeds for the train-step parity tests (not a test itself).

    JAX_PLATFORMS=cpu python tests/torch_seed_scan.py 1 25
    JAX_PLATFORMS=cpu python tests/torch_seed_scan.py 1 7 norm=batch \\
        batch_size=4 faithful_backward_truncation=False

(from the repository root; the script puts the root on sys.path).

For each seed s it runs two train steps in both packages on the batches
tiny_batch(s) and tiny_batch(s + 100) (torch_port_helpers.run_both) and
prints `risky` (kbar entries of the first step within 1e-4 of a non-zero
integer, where `trunc` in the faithful backward can go either way),
`kbar_max`, each network's worst gradient difference as a multiple of the
tests' limit, and the largest relative metric difference of each step.
tests/test_torch_train_step.py pins a seed with risky == 0.
"""

import ast
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import conftest  # noqa: E402,F401  (forces JAX onto the CPU before it starts)

from torch_port_helpers import (TRAINED, configs, flat_dicts,  # noqa: E402
                                jax_params, run_both)


def main(argv):
    first, last = int(argv[0]), int(argv[1])
    fields = dict(batch_size=2, use_dropout=False, mask_type="random")
    for arg in argv[2:]:
        key, value = arg.split("=", 1)
        try:
            fields[key] = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            fields[key] = value
    jcfg, _ = configs(**fields)
    params = jax_params(jcfg, seed=7)
    with tempfile.TemporaryDirectory() as tmp:
        flats = flat_dicts(params, pathlib.Path(tmp))
    for seed in range(first, last):
        r = run_both(fields, params, flats, seeds=(seed, seed + 100))
        worst = {}
        for net in TRAINED:
            worst[net] = max(
                float((g - r["jgrads"][net][k]).abs().max())
                / (1e-4 + (1e-3 * float(r["jgrads"][net][k].abs().max())
                           if net == "G" else 0.0))
                for k, g in r["tgrads"][net].items())
        rel = [max(abs(float(r[f"tm{i}"][k]) / float(r[f"jm{i}"][k]) - 1)
                   for k in r[f"tm{i}"]) for i in (1, 2)]
        print(f"seed {seed}: risky {r['risky']} kbar_max "
              f"{r['kbar_max']:.3f} gradient err/limit "
              f"{ {k: round(v, 3) for k, v in worst.items()} } "
              f"metrics rel {rel[0]:.1e} {rel[1]:.1e}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
