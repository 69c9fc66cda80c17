"""IPSR's part of the benchmark: everything the harness does that depends on
the model, for configurations whose file names no `family` (or `"ipsr"`).

The program's networks are netP (`unet_256`), netG (`unet_ipsr`, with the
shift attention and its two CUDA kernels, the scan and the attention matrix
`kbar`), the frozen VGG16 scorer and, in training, netD (`basic`) and netF
(`feature`).  The reference is reference/ (plain PyTorch), the numbers
compared are compare.py's, the operations counts.py's.  The harness loads
this file by path (harness.load_family) and calls the names below; the
interface is described there.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict

import numpy as np

from portbench import compare, counts, images

TRAIN_LIMITS = {"loss.step1.G", "grad1.median_leaf", "grad1.median_leaf.P",
                "delta3.worst_leaf", "kernels.missing"}
SERVE_LIMITS = {"u8.mean_levels", "kernels.missing"}


def check_cell(config: Dict, kind: str, limits: Dict) -> None:
    """Raise for a cell this family does not state: the reference's widths
    (ngf = 64) at 256 or 512 px, and limits on the numbers it compares."""
    from portbench.reference.step import check_supported
    check_supported(config)
    if config["ngf"] != 64 or config["fine_size"] not in (256, 512):
        raise ValueError("ipsr cells run ngf 64 at 256 or 512 px")
    want = TRAIN_LIMITS if kind == "train" else SERVE_LIMITS
    if set(limits) != want or limits["kernels.missing"] != 0:
        raise ValueError(f"ipsr {kind} cells limit {sorted(want)}, "
                         "kernels.missing at 0")


def program_config(fields: Dict):
    """The program's Config of the configuration file's fields."""
    from deepinpainting_torch.config import Config
    names = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in fields.items() if k in names})


# ---- the program ------------------------------------------------------------

def networks(cfg, train: bool) -> Dict:
    """The program's networks built on the meta device (no host init)."""
    import torch
    from deepinpainting_torch.engine import inpaint as TI
    with torch.device("meta"):
        models = TI.build_models(cfg)
        nets = {"G": models.G, "P": models.P, "vgg": models.vgg}
        if train:
            disc = TI.build_discriminators(cfg)
            nets.update(D=disc.D, F=disc.F)
    return nets


def leaf_std(cfg):
    """The draw of each leaf: conv kernels from N(0, init_gain), VGG's from
    N(0, 2/fan_in); every other leaf (biases, norms) is not drawn."""
    if cfg.init_type != "normal":
        raise ValueError(f"init_type {cfg.init_type!r}: the benchmark draws "
                         "'normal' weights only")

    def std(net, key, shape):
        if len(shape) != 4:
            return None
        return math.sqrt(2.0 / math.prod(shape[1:])) if net == "vgg" \
            else cfg.init_gain
    return std


def train_state(cfg, nets):
    from deepinpainting_torch.engine.state import create_train_state
    return create_train_state(cfg, nets["G"], nets["P"], nets["D"],
                              nets["F"], nets["vgg"].eval())


def train_step(cfg, dev):
    from deepinpainting_torch.engine import inpaint as TI
    return TI.make_train_step(cfg, dev)


def trained(state) -> Dict:
    """{network: (module, its optimiser)} of the networks a step trains."""
    from deepinpainting_torch.engine.state import TRAINED
    return {net: (getattr(state, net), getattr(state, f"opt_{net}"))
            for net in TRAINED}


def session(cfg, nets, traffic: Dict, dev):
    from deepinpainting_torch.engine import inpaint as TI
    from deepinpainting_torch.serve.app import InferenceSession
    models = TI.Models(nets["G"].eval(), nets["P"].eval(), nets["vgg"].eval())
    return InferenceSession(cfg, state=models, max_batch=traffic["max_batch"],
                            batch_wait_ms=traffic["batch_wait_ms"],
                            device=dev)


def inputs(pool: Dict, rows) -> Dict:
    """The image, hole and reference image of pool rows `rows`: the train
    step's batch and InferenceSession.run's arguments.  One request's
    reference is a view of the pool, as its image and hole are: a copy
    would cost each request tens of microseconds on its client's thread."""
    refs = images.ref_index(len(pool["image"]))[rows]
    ref = pool["image"][refs[0]][None] if len(refs) == 1 \
        else pool["image"][refs]
    return {"image": pool["image"][rows], "mask": pool["mask"][rows],
            "ref": ref}


# ---- operations, kernels -----------------------------------------------------

def flops(kind: str, shapes: Dict, cfg) -> Dict[str, float]:
    count = counts.train_flops if kind == "train" else counts.serve_flops
    return count(shapes, cfg.fine_size, cfg.dtype)


def launches() -> Dict[str, int]:
    from deepinpainting_torch.ops import attention_cuda as TAC
    return {"scan": TAC.launches, "kbar": TAC.kbar_launches}


def _masked_counts(masks: np.ndarray, cfg, dev) -> np.ndarray:
    """Masked attention positions of each hole in the pool."""
    import torch
    from portbench.reference.step import feature_flags
    out = []
    for lo in range(0, len(masks), 64):
        m = (torch.as_tensor(masks[lo:lo + 64], device=dev) > 0).float()
        _, flag = feature_flags(m, cfg.threshold, cfg.mask_thred)
        out.append(flag.sum(1).cpu().numpy())
    return np.concatenate(out).astype(np.int64)


def bounds(w, cfg, pool: Dict, dev) -> Dict[str, float]:
    """The kernels' least seconds over the window (counts.py): the scan's
    on each unit's own holes, every launch of a step (the recompute's too)
    reading that step's batch; kbar's a launch."""
    masked = _masked_counts(pool["mask"], cfg, dev)
    n = (cfg.fine_size // 8) ** 2
    c = cfg.ngf * 8
    if w.kind == "serve":
        return {"scan": sum(counts.scan_seconds(n, int(masked[i]), c)
                            for i in w.rows)}
    b = cfg.batch_size
    scan_s = sum(counts.scan_seconds(b * n, int(masked[r].sum()), c)
                 for r in w.rows)
    return {"scan": w.counters["scan_launches"] / w.steps * scan_s,
            "kbar": w.counters["kbar_launches"] * counts.kbar_seconds(b, n)}


def missing(w) -> float:
    """Steps (serving calls) of the window without their kernel launches."""
    c = w.counters
    if w.kind == "serve":
        return float(max(0, c["batches_run"] - c["scan_launches"]))
    return float(max(0, w.steps - c["scan_launches"])
                 + max(0, w.steps - c["kbar_launches"]))


# ---- the reference and the numbers -------------------------------------------

def _precision(cfg, prec):
    import torch
    from portbench.reference import step as R
    return prec or R.Precision({"float32": torch.float32,
                                "bfloat16": torch.bfloat16}[cfg.dtype])


def train_reference(cfg, weights: Dict, batches, dev, prec=None) -> Dict:
    """The reference's losses, first gradients and changes over `batches`
    from the same weights."""
    from portbench.reference import step as R
    ref = R.TrainReference(weights, R.config_dict(cfg), _precision(cfg, prec),
                           dev)
    losses = [ref.step(batch) for batch in batches]
    grad1 = R.leaf_norms(ref.first_grads)
    deltas = R.leaf_norms({net: {k: ref.w[net][k] - weights[net][k]
                                 for k in ref.w[net]}
                           for net in R.TRAINED})
    return {"losses": losses, "grad1": grad1, "delta3": deltas}


def serve_reference(cfg, weights: Dict, batch: Dict, dev, prec=None):
    """The reference's uint8 answers [B,H,W,3] (on `dev`) to a batch."""
    from portbench.reference import step as R
    return R.serve(weights, batch["image"], batch["mask"], batch["ref"],
                   R.config_dict(cfg), _precision(cfg, prec), dev)


def train_numbers(program: Dict, reference: Dict, cfg) -> Dict[str, float]:
    return compare.train_numbers(program, reference, cfg.gan_weight)


def serve_numbers(answers: Dict, reference: Dict) -> Dict[str, float]:
    return compare.serve_numbers(answers, reference)


def train_note(program: Dict, reference: Dict) -> str:
    return f"worst leaves {compare.train_worst_leaves(program, reference)}"


def serve_note(answers: Dict) -> str:
    return (f"{sum(len(v) for v in answers.values())} answers to "
            f"{len(answers)} pool entries checked; the program's own answers "
            f"to one request differ by up to "
            f"{compare.serve_self_spread(answers)!r} levels")


@contextlib.contextmanager
def _tf32():
    import torch
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def control(cfg):
    """(context, reference precision) of calibrate.py's control, one
    precision below cfg.dtype: f32 with TF32 convolutions and matmuls;
    bf16 with float8 e4m3 conv operands."""
    import torch
    from portbench.reference.nets import Precision
    if cfg.dtype == "float32":
        return _tf32(), Precision(torch.float32)
    return contextlib.nullcontext(), Precision(torch.bfloat16,
                                               fp8_operands=True)
