"""The quality run of the port: the JAX package's 20-epoch demo protocol
(artifacts/train_demo, artifacts/kr_ablation/README.md) through the port's
own entry points, on the card.

    python -m deepinpainting_torch.demo --out build/demo [--seed 0]

  1. data: scripts/make_synth_data.py --n 300 --n_valid 32 --size 256, in
     a subprocess (it imports numpy and PIL only, so the data are those of
     the JAX runs);
  2. training: `_cli train` at 128 px, batch 8, --niter 10 --niter_decay
     10 --save_epoch_freq 5 --debug_nan true, refs = images, with the
     validation images;
  3. evaluation: `_cli evaluate` of epochs 5 and 20 on the 32 validation
     images (PSNR and SSIM, utils/metrics.py);
  4. serving: epoch 20 through make_app on ThreadingWSGIServer at an
     ephemeral 127.0.0.1 port, one multipart POST, the result fetched back.

The last line of the output is one JSON object of figures, beside the JAX
records on this protocol (f32, faithful mode): 28.04 / 28.11 dB and 0.803 /
0.802 SSIM at epoch 20.  The data and the checkpoints (1.8 GB each) stay
under --out.
"""

import argparse
import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
NAME = "synth_demo"
JAX_BAND = {"psnr_e20": [28.04, 28.11], "ssim_e20": [0.802, 0.803],
            "spread": {"psnr": 0.14, "ssim": 0.005}}


def _run(cmd, log_path):
    """Run `cmd` with the port importable, its output into `log_path`;
    raise with the log's tail if it fails."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        res = subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT,
                             env=env, cwd=str(REPO))
    if res.returncode != 0:
        with open(log_path) as log:
            tail = log.read()[-4000:]
        raise RuntimeError(f"{cmd[:4]} exited {res.returncode}:\n{tail}")
    return time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="working directory")
    ap.add_argument("--seed", type=int, default=0,
                    help="Config.seed of the run (initial weights, masks)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from PIL import Image

    from . import _cli
    from .config import Config
    from .serve.app import make_app, post_over_socket

    out = Path(args.out).resolve()
    synth, ckpt = out / "synth", out / "checkpoints"
    out.mkdir(parents=True, exist_ok=True)
    figures = {"seed": args.seed, "fine_size": 128, "batch_size": 8,
               "epochs": 20, "jax_records": JAX_BAND}

    if not (synth / "valid").is_dir():
        figures["data_s"] = _run(
            [sys.executable, str(REPO / "scripts" / "make_synth_data.py"),
             "--out", str(synth), "--n", "300", "--n_valid", "32",
             "--size", "256"], out / "data.log")
    train = [sys.executable, "-m", "deepinpainting_torch._cli", "train",
             "--dataroot", str(synth / "img"), "--maskroot",
             str(synth / "mask"), "--refroot", str(synth / "img"),
             "--validroot", str(synth / "valid"), "--validrefroot",
             str(synth / "valid"), "--fine_size", "128", "--batch_size", "8",
             "--niter", "10", "--niter_decay", "10", "--save_epoch_freq", "5",
             "--display_freq", "400", "--debug_nan", "true",
             "--checkpoints_dir", str(ckpt), "--name", NAME,
             "--seed", str(args.seed), "--device", args.device]
    figures["train_s"] = _run(train, out / "train.log")
    # 37 batches of 8 an epoch; the wall time holds start-up, data,
    # validation and checkpoint writes
    figures["train_wall_img_s"] = 37 * 8 * 20 / figures["train_s"]
    print(f"[demo] trained 20 epochs in {figures['train_s']:.1f} s",
          flush=True)

    for epoch in (5, 20):
        res = _cli.evaluate(
            ["--dataroot", str(synth / "valid"), "--maskroot",
             str(synth / "mask"), "--checkpoints_dir", str(ckpt),
             "--name", NAME, "--which_epoch", str(epoch), "--max_images",
             "32", "--device", args.device])
        figures[f"psnr_e{epoch}"] = res["psnr"]
        figures[f"ssim_e{epoch}"] = res["ssim"]
        figures[f"images_e{epoch}"] = res["images"]

    cfg = Config.load(str(ckpt / NAME / "config.json")).replace(
        checkpoints_dir=str(ckpt), name=NAME)
    valid = sorted((synth / "valid").iterdir())
    masks = sorted((synth / "mask").iterdir())
    app = make_app(cfg, 20, str(out / "static"), device=args.device)
    status, location, ms, jpg = post_over_socket(app, {
        "srcImage": valid[0].read_bytes(), "binaryMask": masks[0].read_bytes(),
        "refImage": valid[1].read_bytes()})
    size = Image.open(io.BytesIO(jpg)).size
    figures["served"] = {"status": status, "location": location,
                         "post_ms": ms, "result_size": list(size),
                         "result_bytes": len(jpg)}
    ok = status == 302 and location == "/result" and size == (128, 128)
    print(json.dumps(figures))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
