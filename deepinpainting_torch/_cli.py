"""Command-line training and evaluation with the port (counterpart of
deepinpainting_tpu/_cli.py::train, evaluate):

    python -m deepinpainting_torch._cli train --dataroot D --maskroot M \
        --refroot R [--validroot V] [--device cpu] [--<any Config field> V]
    python -m deepinpainting_torch._cli evaluate --dataroot D --maskroot M \
        --name N --which_epoch E [--save_dir S] [--device cpu]

Both run on the card unless given --device cpu.  This module imports no
torch at module level: the data loader's spawned workers import it as
their main module.
"""

import argparse
import dataclasses
import os
import sys

from .config import Config


def add_config_flags(parser: argparse.ArgumentParser) -> None:
    """Every Config field becomes a --flag with its default."""
    for f in dataclasses.fields(Config):
        if isinstance(f.default, bool):
            parser.add_argument(f"--{f.name}", type=lambda s: s.lower() in
                                ("1", "true", "yes"), default=f.default)
        else:
            parser.add_argument(f"--{f.name}", type=type(f.default),
                                default=f.default)


def train(argv=None):
    ap = argparse.ArgumentParser(description="train the inpainting model")
    ap.add_argument("--dataroot", required=True, help="training images dir")
    ap.add_argument("--maskroot", required=True, help="mask png dir")
    ap.add_argument("--refroot", required=True, help="reference images dir")
    ap.add_argument("--validroot", default="", help="validation images dir")
    ap.add_argument("--validrefroot", default="", help="validation refs dir")
    ap.add_argument("--profile_dir", default="",
                    help="write a torch.profiler Chrome trace here")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    add_config_flags(ap)
    args = ap.parse_args(argv)
    field_names = {f.name for f in dataclasses.fields(Config)}
    cfg = Config(**{k: v for k, v in vars(args).items() if k in field_names})

    from .data import InpaintDataset
    from .engine.trainer import Trainer

    train_ds = InpaintDataset(args.dataroot, args.maskroot, args.refroot,
                              cfg.fine_size, seed=cfg.seed)
    valid_ds = None
    if args.validroot:
        valid_ds = InpaintDataset(args.validroot, args.maskroot,
                                  args.validrefroot or args.refroot,
                                  cfg.fine_size, seed=cfg.seed + 1)
    print(f"train images: {len(train_ds)}"
          + (f", valid images: {len(valid_ds)}" if valid_ds else ""))
    trainer = Trainer(cfg, train_ds, valid_ds, device=args.device)
    trainer.fit(profile_dir=args.profile_dir or None)


def evaluate(argv=None):
    ap = argparse.ArgumentParser(description="PSNR/SSIM of a checkpoint")
    ap.add_argument("--dataroot", required=True)
    ap.add_argument("--maskroot", required=True)
    ap.add_argument("--checkpoints_dir", default="checkpoints")
    ap.add_argument("--name", default="IPSR_inpainting")
    ap.add_argument("--which_epoch", type=int, required=True)
    ap.add_argument("--max_images", type=int, default=500)
    ap.add_argument("--batch_size", type=int, default=0,
                    help="override the checkpoint config's batch size")
    ap.add_argument("--vgg_weights", default="",
                    help="override the checkpoint config's vgg npz path")
    ap.add_argument("--save_dir", default="", help="dump 2x2 eval grids here")
    ap.add_argument("--quant", default="", choices=["", "none", "int8"],
                    help="override the checkpoint config's quant mode")
    ap.add_argument("--faithful_known_replacement", default="",
                    choices=["", "true", "false"],
                    help="override the checkpoint config's known-position "
                         "replacement quirk (an inference-time behaviour)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    import torch

    from .data.dataset import SelfRefDataset
    from .engine import create_state
    from .engine.checkpoint import CheckpointManager
    from .engine.evaluator import evaluate as run_eval

    cfg_path = os.path.join(args.checkpoints_dir, args.name, "config.json")
    cfg = Config.load(cfg_path).replace(
        checkpoints_dir=args.checkpoints_dir, name=args.name, is_train=False)
    if args.batch_size:
        cfg = cfg.replace(batch_size=args.batch_size)
    if args.vgg_weights:
        cfg = cfg.replace(vgg_weights=args.vgg_weights)
    if args.quant:
        cfg = cfg.replace(quant=args.quant)
    if args.faithful_known_replacement:
        cfg = cfg.replace(faithful_known_replacement=(
            args.faithful_known_replacement == "true"))

    mgr = CheckpointManager(cfg)   # restore-only: never writes config.json
    state = mgr.restore(args.which_epoch,
                        create_state(cfg, torch.Generator().manual_seed(0),
                                     args.device), args.device)
    ds = SelfRefDataset(args.dataroot, args.maskroot, cfg.fine_size)
    print(f"test images: {len(ds)}")
    return run_eval(cfg, state, ds, max_images=args.max_images,
                    save_dir=args.save_dir or None, device=args.device)


COMMANDS = {"train": train, "evaluate": evaluate}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in COMMANDS:
        print(f"usage: python -m deepinpainting_torch._cli "
              f"{{{','.join(COMMANDS)}}} [options]", file=sys.stderr)
        return 2
    COMMANDS[argv[0]](argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
