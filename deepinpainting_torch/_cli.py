"""Command-line training and evaluation with the port (counterpart of
deepinpainting_tpu/_cli.py::train, evaluate):

    python -m deepinpainting_torch._cli train --dataroot D --maskroot M \
        --refroot R [--validroot V] [--device cpu] [--stop_epoch N] \
        [--<any Config field> V]
    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m deepinpainting_torch._cli train --multihost [--sp_devices K] ...
    python -m deepinpainting_torch._cli evaluate --dataroot D --maskroot M \
        --name N --which_epoch E [--save_dir S] [--quant int8] [--device cpu]
    python -m deepinpainting_torch._cli serve [--which_epoch E | \
        --random_weights | --from_export DIR] [--max_batch 8] \
        [--quant int8] [--device cpu]
    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m deepinpainting_torch._cli serve --sp [--quant int8] ...
    python -m deepinpainting_torch._cli export --out DIR \
        [--which_epoch E | --random_weights] [--batches 1,8] [--quant int8] \
        [--device cpu | --platforms cuda,cpu] [--attention_impl torch]

Each runs on the card unless given --device cpu.  This module imports no
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
    ap.add_argument("--stop_epoch", type=int, default=0,
                    help="stop after this epoch, on the schedule that "
                         "--niter/--niter_decay set (resume later with "
                         "--continue_train true --which_epoch N); 0: run "
                         "to the last epoch")
    ap.add_argument("--multihost", action="store_true",
                    help="data-parallel training: run this command once a "
                         "rank (torch.distributed.run starts them and sets "
                         "RANK/WORLD_SIZE/MASTER_ADDR/MASTER_PORT/"
                         "LOCAL_RANK, or give --coordinator/"
                         "--num_processes/--process_id); nccl on the card, "
                         "gloo with --device cpu.  Each rank decodes its "
                         "rows of the global batch (--batch_size); rank 0 "
                         "writes metrics, config and checkpoints")
    ap.add_argument("--coordinator", default="",
                    help="coordinator address host:port (multihost; omit "
                         "to read the group from the environment)")
    ap.add_argument("--num_processes", type=int, default=0,
                    help="total process count (multihost; 0: from the "
                         "environment)")
    ap.add_argument("--process_id", type=int, default=-1,
                    help="this process's rank (multihost; -1: from the "
                         "environment)")
    add_config_flags(ap)
    args = ap.parse_args(argv)
    field_names = {f.name for f in dataclasses.fields(Config)}
    cfg = Config(**{k: v for k, v in vars(args).items() if k in field_names})

    device = args.device
    if args.multihost:
        given = [bool(args.coordinator), args.num_processes > 0,
                 args.process_id >= 0]
        if any(given) and not all(given):
            ap.error(
                "--coordinator/--num_processes/--process_id must be given "
                "together (or all omitted, in which case the group is read "
                "from the environment that torch.distributed.run sets)")
        import torch.distributed as dist

        from .parallel.mesh import init_distributed
        device = init_distributed(args.device, None,
                                  args.coordinator or None,
                                  args.num_processes, args.process_id)
        if dist.get_rank() == 0:
            print(f"multihost: process {dist.get_rank()}/"
                  f"{dist.get_world_size()}, device {device}, backend "
                  f"{dist.get_backend()}", flush=True)

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
    trainer = Trainer(cfg, train_ds, valid_ds, device=device)
    try:
        trainer.fit(profile_dir=args.profile_dir or None,
                    stop_epoch=args.stop_epoch or None)
    finally:
        if args.multihost:
            dist.destroy_process_group()


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
    # the state is a training one, which int8 (inference only) cannot build
    template = create_state(cfg.replace(quant="none"),
                            torch.Generator().manual_seed(0), args.device)
    state = mgr.restore(args.which_epoch, template, args.device)
    ds = SelfRefDataset(args.dataroot, args.maskroot, cfg.fine_size)
    print(f"test images: {len(ds)}")
    return run_eval(cfg, state, ds, max_images=args.max_images,
                    save_dir=args.save_dir or None, device=args.device)


def _serving_config(args):
    """The run's config.json under --checkpoints_dir/--name if there is
    one, else Config() (counterpart of the JAX CLI's serve/export); an
    option the port does not run is refused by name here."""
    from .engine.inpaint import check_config

    cfg_path = os.path.join(args.checkpoints_dir, args.name, "config.json")
    cfg = Config.load(cfg_path) if os.path.exists(cfg_path) else Config()
    cfg = cfg.replace(checkpoints_dir=args.checkpoints_dir, name=args.name,
                      is_train=False)
    if args.quant:
        cfg = cfg.replace(quant=args.quant)
    check_config(cfg)
    return cfg


def export(argv=None):
    """Export a checkpoint's serving function as an artifact
    (engine/export_model.py): a torch.export graph, config.json and the
    npz weights, loadable with load_serving or `serve --from_export`."""
    ap = argparse.ArgumentParser(description=export.__doc__)
    ap.add_argument("--checkpoints_dir", default="checkpoints")
    ap.add_argument("--name", default="IPSR_inpainting")
    ap.add_argument("--which_epoch", type=int, default=None,
                    help="epoch checkpoint to export (default 46; omit and "
                         "give --random_weights for a smoke artifact)")
    ap.add_argument("--random_weights", action="store_true")
    ap.add_argument("--out", required=True, help="artifact directory")
    ap.add_argument("--quant", default="", choices=["", "none", "int8"],
                    help="override the checkpoint config's quant mode "
                         "(int8: dynamic int8 convs, ops/quant.py)")
    ap.add_argument("--batches", default="",
                    help="comma-separated batch sizes to export as a fixed "
                         "set, e.g. '1,8' (default: a symbolic batch "
                         "dimension, falling back to 1,8)")
    ap.add_argument("--device", default="cuda",
                    help="the device type the artifact serves on: 'cuda' "
                         "(default) or 'cpu'")
    ap.add_argument("--platforms", default="",
                    help="comma-separated device types to trace one graph "
                         "each for, e.g. 'cuda,cpu', over one copy of the "
                         "weights (in place of --device)")
    ap.add_argument("--attention_impl", default="",
                    choices=["", "cuda", "pallas", "torch", "lax"],
                    help="the attention scan of the graph: 'cuda' (or the "
                         "JAX name 'pallas', the default) calls the CUDA "
                         "kernel's op; 'torch' (or 'lax') the plain "
                         "recurrence's, on every device with no kernel")
    args = ap.parse_args(argv)

    import torch

    from .engine.checkpoint import CheckpointManager
    from .engine.export_model import check_platforms, export_serving
    from .engine.inpaint import init_params

    cfg = _serving_config(args)
    if args.attention_impl:
        cfg = cfg.replace(attention_impl=args.attention_impl)
    platforms = None
    device = args.device
    if args.platforms:
        platforms = check_platforms(args.platforms.split(","))
        # the weights load once, on the card if a graph is traced there
        device = "cuda" if "cuda" in platforms else "cpu"
    if args.random_weights:
        models = init_params(cfg, torch.Generator().manual_seed(cfg.seed),
                             device)
    else:
        # 46: the reference's serving default, as `serve` takes it
        epoch = 46 if args.which_epoch is None else args.which_epoch
        models = CheckpointManager(cfg).restore_models(epoch, device)
    batches = [int(b) for b in args.batches.split(",") if b] or None
    out = export_serving(cfg, models, args.out, batch_sizes=batches,
                         device=device, platforms=platforms)
    print(f"exported serving artifact -> {out}")
    return out


def serve(argv=None):
    """Serve the browser demo (serve/app.py) on a threading WSGI server."""
    ap = argparse.ArgumentParser(description=serve.__doc__)
    ap.add_argument("--checkpoints_dir", default="checkpoints")
    ap.add_argument("--name", default="IPSR_inpainting")
    ap.add_argument("--which_epoch", type=int, default=None,
                    help="epoch checkpoint to serve (default 46; omit and "
                         "give --random_weights for a smoke run)")
    ap.add_argument("--random_weights", action="store_true",
                    help="serve weights drawn from the config's seed")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=5000)
    ap.add_argument("--static_dir", default="")
    ap.add_argument("--max_batch", type=int, default=1,
                    help="coalesce up to N concurrent requests into one "
                         "device call (serve/batcher.py); 1 disables")
    ap.add_argument("--batch_wait_ms", type=float, default=2.0,
                    help="max straggler wait when coalescing")
    ap.add_argument("--sp", action="store_true",
                    help="spread each request's rows over the ranks that "
                         "torch.distributed.run starts (parallel/"
                         "spatial.py): rank 0 serves, the others follow; "
                         "one rank (no launcher) serves plainly")
    ap.add_argument("--quant", default="", choices=["", "none", "int8"],
                    help="override the checkpoint config's quant mode "
                         "(int8: dynamic int8 convs, ops/quant.py)")
    ap.add_argument("--from_export", default="",
                    help="serve an artifact directory (`export`) instead "
                         "of a checkpoint")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    if args.from_export and (args.quant or args.sp
                             or args.which_epoch is not None
                             or args.random_weights):
        # the artifact is a traced graph with its weights; these options
        # belong to `export`, and ignoring them would mislead
        ap.error("--from_export serves the artifact exactly as exported; "
                 "it cannot be combined with --quant/--sp/"
                 "--which_epoch/--random_weights (export again with the "
                 "wanted options instead)")

    from wsgiref.simple_server import make_server

    import torch.distributed as dist

    from .serve.app import InferenceSession, ThreadingWSGIServer, make_app

    cfg = _serving_config(args)
    epoch = args.which_epoch
    if epoch is None and not args.random_weights:
        epoch = 46      # the reference's default
    device = args.device
    joined = args.sp and int(os.environ.get("WORLD_SIZE", "1")) > 1
    if joined:
        # started by torch.distributed.run: one request's rows over the
        # ranks (nccl on the card, gloo with --device cpu)
        from .parallel.mesh import init_distributed
        device = init_distributed(args.device)
    try:
        if args.sp and dist.is_initialized() and dist.get_rank() != 0:
            InferenceSession(cfg, epoch, sp=True, device=device).follow()
            return
        app = make_app(cfg, epoch, args.static_dir or None,
                       max_batch=args.max_batch,
                       batch_wait_ms=args.batch_wait_ms, sp=args.sp,
                       from_export=args.from_export or None, device=device)
        try:
            print(f"serving on http://{args.host}:{args.port}"
                  + (f" (coalescing up to {args.max_batch} requests)"
                     if args.max_batch > 1 else "")
                  + (f" (each request over {dist.get_world_size()} ranks)"
                     if app.session.grid is not None else ""), flush=True)
            make_server(args.host, args.port, app,
                        server_class=ThreadingWSGIServer).serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            app.session.close()       # releases an sp session's followers
    finally:
        if joined:
            dist.destroy_process_group()


COMMANDS = {"train": train, "evaluate": evaluate, "export": export,
            "serve": serve}


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
