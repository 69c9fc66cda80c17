"""The port's own copy of the framework's frozen configuration.

Field for field the same as the JAX package's Config (same names, same
defaults), so one Config JSON loads in both packages.  The port keeps a copy
rather than importing it: it must load without the JAX package present.

Fields whose feature the port does not run yet (training, bf16, int8, the
conv pack modes, norm='batch', spatial partitioning) are kept for JSON
compatibility; engine/inpaint.py::build_models rejects the values it cannot
honour.  `attention_impl` also takes the port's own names: 'cuda' (the
hand-written scan kernel; 'pallas' selects the same) and 'torch' (the plain
PyTorch recurrence; 'lax' selects the same).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass


@dataclass(frozen=True)
class Config:
    # ---- geometry ----------------------------------------------------------
    batch_size: int = 1
    data_workers: int = -1        # host decode worker processes
    fine_size: int = 256          # square image resolution (reference `fineSize`)
    input_nc: int = 3             # stage-1 (rough net) input channels
    input_nc_g: int = 6           # stage-2 (refinement net) input channels
    output_nc: int = 3
    ngf: int = 64                 # generator base width
    ndf: int = 64                 # discriminator base width

    # ---- model selection (reference `which_model_*`) -----------------------
    which_model_netG: str = "unet_ipsr"
    which_model_netP: str = "unet_256"
    which_model_netD: str = "basic"
    which_model_netF: str = "feature"
    norm: str = "instance"        # 'instance' | 'batch'
    use_dropout: bool = False
    init_type: str = "normal"     # 'normal'|'xavier'|'kaiming'|'orthogonal'
    init_gain: float = 0.02       # normal std / xavier+orthogonal gain

    # ---- attention (IPSR / CSA shift layer) --------------------------------
    threshold: float = 5.0 / 16.0  # feature-mask binarization threshold
    stride: int = 1
    shift_sz: int = 1              # feature patch size
    mask_thred: float = 1.0        # per-patch mask-sum threshold for "masked"
    triple_weight: float = 1.0     # backward attention gradient weight
    # Reference-quirk fidelity switches: True reproduces the reference,
    # False the corrected behaviour.
    faithful_backward_truncation: bool = True   # truncated attention rows in bwd
    faithful_detached_cosis: bool = True        # InnerCos losses detached
    faithful_known_replacement: bool = True     # attention rewrites KNOWN
    # (unmasked) positions with their best-ref-matching patch instead of
    # identity — the one quirk that changes INFERENCE output.
    attention_impl: str = "pallas"  # 'pallas'/'cuda' kernel | 'lax'/'torch' plain
    remat: bool = False            # checkpoint U-Net levels (training)
    remat_depth: int = 1           # how many OUTERMOST levels to checkpoint

    # ---- masks -------------------------------------------------------------
    mask_type: str = "random"      # 'center' | 'random'
    overlap: int = 4               # center-mask inset (reference `overlap`)

    # ---- losses ------------------------------------------------------------
    lambda_A: float = 100.0
    gan_type: str = "lsgan"        # 'lsgan' | 'wgan_gp' (MSE) | 'vanilla' (BCE)
    gan_weight: float = 0.2
    cosis: int = 1                 # include InnerCos feature-consistency losses
    strength: float = 1.0          # InnerCos strength multiplier
    skip: int = 0                  # skip InnerCos losses entirely

    # ---- optimization ------------------------------------------------------
    lr: float = 2e-4
    beta1: float = 0.5
    lr_policy: str = "lambda"      # 'lambda' | 'step' | 'plateau' | 'cosine'
    lr_decay_iters: int = 50
    niter: int = 20
    niter_decay: int = 100
    epoch_count: int = 1

    # ---- bookkeeping -------------------------------------------------------
    name: str = "IPSR_inpainting"
    checkpoints_dir: str = "checkpoints"
    which_epoch: str = ""
    save_epoch_freq: int = 1
    display_freq: int = 1000
    continue_train: bool = False
    is_train: bool = True
    early_stop_patience: int = 20

    # ---- compute -----------------------------------------------------------
    dtype: str = "float32"         # activation compute dtype
    quant: str = "none"            # 'none' | 'int8' (inference PTQ)
    pack_small_cin: bool = False   # exact small-Cin conv rewrite
    pack_out: bool = False         # exact output-pixel packing rewrite
    grad_accum: int = 1            # microbatches per optimizer step
    debug_nan: bool = False        # halt training on non-finite losses
    metrics_every: int = 10        # fetch step metrics every K steps
    seed: int = 0
    vgg_weights: str = "random"    # 'random' or a path to a converted .npz
    vgg_width_scale: float = 1.0   # <1 only for scaled-down test configs
    data_axis: str = "data"        # data-parallel axis name
    sp_devices: int = 1            # spatial-partitioning axis size

    # ------------------------------------------------------------------------
    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "Config":
        raw = json.loads(text)
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in fields})

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_json(f.read())
