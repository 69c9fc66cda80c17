"""One train step of the `f32` protocol from the same weights and the same
first batch, on the card and on the CPU of the same machine, and where
the two part: VGG's reference features, G's features at the attention
level, the attention's patch choice (the argmax of the scores) and its
margin, kbar, the losses.

    python studies/card_vs_cpu_step.py --out build/cvc --ngf 16 --seed 1

The weights are the port's draw at --seed (create_state, as its Trainer
draws them); the batch is the first of the protocol's epoch 1 (the
dataset at --seed, the iterator at --seed + 1, as the Trainer builds
them).  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import common  # noqa: F401  (the repository on sys.path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--ngf", type=int, default=16)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    import torch

    from deepinpainting_torch import demo
    from deepinpainting_torch.data import BatchIterator, InpaintDataset
    from deepinpainting_torch.engine import inpaint as TI
    from deepinpainting_torch.ops import attention as TA

    width = ("--ngf", str(args.ngf), "--ndf", str(args.ngf),
             "--vgg_width_scale", str(args.ngf / 64))
    cfg = demo.train_config(list(demo.COMMON) + list(width)).replace(
        seed=args.seed)
    data, _ = demo.make_data(Path(args.out), demo.DATA["synth"])
    ds = InpaintDataset(str(data / "img"), str(data / "mask"),
                        str(data / "img"), cfg.fine_size, seed=cfg.seed)
    batch = next(iter(BatchIterator(ds, cfg.batch_size, seed=cfg.seed + 1,
                                    workers=0)))
    core = TA.attention_core_batched
    runs = {}
    # without a card (a rehearsal) the "card" runs take the CPU too
    card_dev = "cuda" if torch.cuda.is_available() else "cpu"
    for name, dev, impl in (("cpu", "cpu", "cuda"), ("card", card_dev, "cuda"),
                            ("card_plain", card_dev, "torch")):
        seen = []

        def spy(feat, ref, flag, **kw):
            out, kbar = core(feat, ref, flag, **kw)
            _, _, ind, vmax, _ = TA.prep(
                feat.flatten(2).transpose(1, 2), ref.flatten(2).transpose(
                    1, 2), flag.to(torch.float32), kw["known_replacement"])
            seen.append({k: v.detach().double().cpu() for k, v in dict(
                feat=feat, ref=ref, out=out, kbar=kbar, ind=ind,
                vmax=vmax).items()})
            return out, kbar

        state = TI.create_state(cfg.replace(attention_impl=impl),
                                torch.Generator().manual_seed(cfg.seed), dev)
        TA.attention_core_batched = spy
        try:
            _, m = TI.make_train_step(cfg.replace(attention_impl=impl),
                                      dev)(state, batch)
        finally:
            TA.attention_core_batched = core
        runs[name] = dict(seen[0], metrics={k: float(v) for k, v in m.items()})
        del state

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    cpu, card = runs["cpu"], runs["card"]
    # the patch choice, and its margin in f64 on each side's own inputs
    pn = cpu["feat"].flatten(2).transpose(1, 2)
    pn = pn / (pn.norm(dim=2, keepdim=True) + 1e-7)
    scores = pn @ cpu["ref"].flatten(2)          # [B, patch, pos]
    top2 = scores.topk(2, dim=1).values
    margin = (top2[:, 0] - top2[:, 1])           # [B, pos]
    differ = cpu["ind"] != card["ind"]
    out = {
        "card": (torch.cuda.get_device_name(0) if card_dev == "cuda"
                 else "cpu (a rehearsal)"),
        "metrics": {k: runs[k]["metrics"] for k in runs},
        "ref_rel": rel(card["ref"], cpu["ref"]),
        "feat_rel": rel(card["feat"], cpu["feat"]),
        "ind_differ": int(differ.sum()), "positions": int(differ.numel()),
        "margin_where_differ": margin[differ].tolist()[:20],
        "margin_median": float(margin.median()),
        "vmax_rel": rel(card["vmax"], cpu["vmax"]),
        "kbar_max_cpu": float(cpu["kbar"].abs().max()),
        "kbar_max_card": float(card["kbar"].abs().max()),
        "kbar_diff": float((card["kbar"] - cpu["kbar"]).abs().max()),
        "out_rel": rel(card["out"], cpu["out"]),
        "plain_vs_kernel_out": float(
            (runs["card_plain"]["out"] - card["out"]).abs().max()),
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
