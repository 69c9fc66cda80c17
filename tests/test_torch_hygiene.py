"""The port's boundaries: it imports nothing of JAX or of the JAX package,
its entry points never fall back to the CPU on their own, and
chip_smoke.py refuses to report a result without a CUDA card or outside
the repository."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from deepinpainting_torch import entry as TE
from deepinpainting_torch.config import Config
from deepinpainting_torch.device import resolve_device
from deepinpainting_torch.engine import inpaint as TI
from deepinpainting_torch.serve.app import InferenceSession

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "deepinpainting_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "deepinpainting_tpu")
TINY = Config(fine_size=64, ngf=8, ndf=8, vgg_width_scale=1 / 8)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_import_loads_no_jax():
    code = (
        "import sys\n"
        "import deepinpainting_torch, deepinpainting_torch.entry\n"
        "import deepinpainting_torch.serve.app, deepinpainting_torch._build\n"
        "import deepinpainting_torch.convert.jax_bridge\n"
        "import deepinpainting_torch.ops.attention_cuda\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_sources_import_no_jax():
    pattern = re.compile(
        r"^\s*(?:import|from)\s+(" + "|".join(FORBIDDEN) + r")\b"
        r"|__import__\(\s*['\"](" + "|".join(FORBIDDEN) + r")"
        r"|import_module\(\s*['\"](" + "|".join(FORBIDDEN) + r")",
        re.MULTILINE)
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [f"{f.relative_to(REPO)}: {m.group(0).strip()}"
                 for f in files for m in pattern.finditer(f.read_text())]
    assert not offenders, offenders


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_to_fall_back_to_cpu(no_card):
    gen = torch.Generator().manual_seed(0)
    calls = [
        lambda: resolve_device(),
        lambda: resolve_device("cuda"),
        lambda: TI.init_params(TINY, gen),
        lambda: TI.make_inference_fn(TINY),
        lambda: TI.make_serving_fn(TINY),
        lambda: InferenceSession(TINY),
        lambda: TE.entry(cfg=TINY),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # asked for by name, the CPU works
    assert resolve_device("cpu").type == "cpu"
    fn, args = TE.entry(device="cpu", cfg=TINY)
    assert fn(*args).shape == (1, 64, 64, 3)


def test_unported_options_are_refused():
    for kw in (dict(norm="batch"), dict(dtype="bfloat16"),
               dict(quant="int8"), dict(pack_out=True),
               dict(pack_small_cin=True), dict(norm="group"),
               dict(init_type="uniform"), dict(which_model_netG="unet_256")):
        with pytest.raises(NotImplementedError):
            TI.build_models(TINY.replace(**kw))
    for kw in (dict(fine_size=32), dict(ngf=16),
               dict(attention_impl="xla")):
        with pytest.raises(ValueError):
            TI.build_models(TINY.replace(**kw))


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={k: v for k, v in os.environ.items()
                               if k != "PYTHONPATH"})


def test_chip_smoke_fails_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for cwd in (REPO, tmp_path):
        if cwd == tmp_path:   # chip_smoke.py alone, nothing else of the repo
            shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        res = _run_smoke(cwd)
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout
