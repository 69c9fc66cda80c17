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
from deepinpainting_torch.engine.checkpoint import CheckpointManager
from deepinpainting_torch.engine.evaluator import evaluate
from deepinpainting_torch.engine.export_model import (export_serving,
                                                      load_serving)
from deepinpainting_torch.engine.trainer import Trainer
from deepinpainting_torch.parallel import spatial
from deepinpainting_torch.parallel.mesh import init_distributed
from deepinpainting_torch.serve.app import InferenceSession, make_app

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
        "import deepinpainting_torch.convert.net_import\n"
        "import deepinpainting_torch.convert.vgg_import\n"
        "import deepinpainting_torch.ops.attention_cuda\n"
        "import deepinpainting_torch.losses\n"
        "import deepinpainting_torch.engine.state\n"
        "import deepinpainting_torch.engine.schedules\n"
        "import deepinpainting_torch.models.discriminators\n"
        "import deepinpainting_torch.data, deepinpainting_torch._cli\n"
        "import deepinpainting_torch.engine.trainer\n"
        "import deepinpainting_torch.engine.evaluator\n"
        "import deepinpainting_torch.engine.checkpoint\n"
        "import deepinpainting_torch.engine.export_model\n"
        "import deepinpainting_torch.demo\n"
        "import deepinpainting_torch.utils.profiling\n"
        "import deepinpainting_torch.utils.params\n"
        "import deepinpainting_torch.parallel.mesh\n"
        "import deepinpainting_torch.parallel.spatial\n"
        "import deepinpainting_torch.parallel.collectives\n"
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
    # the data pipeline runs in spawned loader workers: no torch at module
    # level there (device_batches imports it inside the function)
    top_torch = re.compile(r"^(?:import|from)\s+torch\b", re.MULTILINE)
    data = sorted((PORT / "data").glob("*.py"))
    assert len(data) >= 3
    assert not [f.name for f in data if top_torch.search(f.read_text())]


def test_sources_name_nothing_under_scripts():
    """The port keeps its own copy of what it needs from the JAX
    repository's scripts/ (data/synth.py): no source of the port, and not
    chip_smoke.py, names a path under it or runs it."""
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    pattern = re.compile(r"\bscripts\b\s*[/\\'\"]")
    offenders = [f"{f.relative_to(REPO)}:{i}: {line.strip()}"
                 for f in files
                 for i, line in enumerate(f.read_text().splitlines(), 1)
                 if pattern.search(line)]
    assert not offenders, offenders


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_to_fall_back_to_cpu(no_card, tmp_path):
    gen = torch.Generator().manual_seed(0)
    ckpt_cfg = TINY.replace(checkpoints_dir=str(tmp_path))
    calls = [
        lambda: resolve_device(),
        lambda: resolve_device("cuda"),
        lambda: TI.init_params(TINY, gen),
        lambda: TI.init_discriminators(TINY, gen),
        lambda: TI.create_state(TINY, gen),
        lambda: TI.make_train_step(TINY),
        lambda: TI.make_inference_fn(TINY),
        lambda: TI.make_serving_fn(TINY),
        lambda: InferenceSession(TINY),
        lambda: TE.entry(cfg=TINY),
        lambda: TI.make_eval_step(TINY),
        lambda: TI.make_coarse_fn(TINY),
        lambda: Trainer(ckpt_cfg, None),
        lambda: evaluate(TINY, None, None),
        lambda: CheckpointManager(ckpt_cfg).restore(1, None),
        lambda: CheckpointManager(ckpt_cfg).restore_models(1),
        lambda: InferenceSession(ckpt_cfg, 1),
        lambda: make_app(ckpt_cfg, 1),
        lambda: make_app(TINY, from_export=str(tmp_path)),
        lambda: export_serving(TINY, None, str(tmp_path / "art")),
        lambda: load_serving(str(tmp_path)),
        lambda: init_distributed(),
        lambda: init_distributed("cuda", "gloo"),
        lambda: spatial.make_sp_inference_fn(TINY, None, None),
        lambda: spatial.make_dp_sp_train_step(TINY, None, None),
        lambda: spatial.make_dp_sp_eval_step(TINY, None, None),
        lambda: InferenceSession(TINY, sp=True),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # asked for by name, the CPU works
    assert resolve_device("cpu").type == "cpu"
    fn, args = TE.entry(device="cpu", cfg=TINY)
    assert fn(*args).shape == (1, 64, 64, 3)


def test_init_distributed_takes_gloo_on_a_card_only_when_named(
        monkeypatch, tmp_path):
    """nccl for a card and gloo for the CPU, unless the caller names the
    backend; never gloo on a card on its own, and the device of a card is
    cuda:LOCAL_RANK."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", lambda dev: None)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setenv("LOCAL_RANK", "1")
    url = f"file://{tmp_path}/rendezvous"
    trio = dict(coordinator=url, num_processes=2, process_id=1)
    assert init_distributed("cuda", **trio) == torch.device("cuda", 1)
    assert init_distributed("cuda", "gloo", **trio).type == "cuda"
    assert init_distributed("cpu", **trio) == torch.device("cpu")
    init_distributed("cuda", coordinator="localhost:29500",
                     num_processes=2, process_id=1)
    init_distributed("cuda")
    assert [b for b, _ in calls] == ["nccl", "gloo", "gloo", "nccl", "nccl"]
    assert calls[0][1] == dict(init_method=url, world_size=2, rank=1)
    assert calls[3][1]["init_method"] == "tcp://localhost:29500"
    assert calls[4][1] == dict(init_method="env://")


def test_cuda_device_turns_tf32_off(monkeypatch):
    """f32 on the card is full f32, as in the reference: every entry point
    resolves its device, and resolving a CUDA one turns TF32 off."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    resolve_device("cpu")
    assert torch.backends.cudnn.allow_tf32
    assert resolve_device().type == "cuda"
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def test_unported_options_are_refused():
    for kw in (dict(dtype="float16"),
               dict(quant="int4"), dict(norm="group"),
               dict(init_type="uniform"), dict(which_model_netG="unet_256")):
        with pytest.raises(NotImplementedError):
            TI.build_models(TINY.replace(**kw))
        with pytest.raises(NotImplementedError):
            TI.build_discriminators(TINY.replace(**kw))
    for kw in (dict(fine_size=32), dict(ngf=16),
               dict(attention_impl="xla")):
        with pytest.raises(ValueError):
            TI.build_models(TINY.replace(**kw))
    # options training does not run, each refused by its name (int8 is
    # inference only, as in the JAX package)
    gen = torch.Generator().manual_seed(0)
    for kw in (dict(dtype="float16"), dict(quant="int8")):
        name = next(iter(kw))
        with pytest.raises(NotImplementedError, match=name):
            TI.make_train_step(TINY.replace(**kw), "cpu")
        with pytest.raises(NotImplementedError, match=name):
            TI.create_state(TINY.replace(**kw), gen, "cpu")
    with pytest.raises(ValueError, match="gan_type"):
        TI.make_train_step(TINY.replace(gan_type="hinge"), "cpu")
    # norm='batch', the bf16 compute dtype, remat, grad_accum and the
    # conv modes are ported: they build (int8 for inference); debug_nan is
    # the trainer's guard, and the step builds with it
    TI.build_models(TINY.replace(norm="batch"))
    TI.build_models(TINY.replace(quant="int8"))
    TI.build_discriminators(TINY.replace(quant="int8"))
    packed = TINY.replace(pack_small_cin=True, pack_out=True)
    TI.build_models(packed)
    TI.make_train_step(packed, "cpu")
    TI.create_state(packed, gen, "cpu")
    ported = TINY.replace(dtype="bfloat16", remat=True, remat_depth=0,
                          grad_accum=2, batch_size=2)
    TI.build_models(ported)
    TI.make_train_step(ported, "cpu")
    TI.create_state(ported, gen, "cpu")
    TI.make_train_step(TINY.replace(debug_nan=True), "cpu")
    TI.create_state(TINY.replace(debug_nan=True), gen, "cpu")


CONSOLE_SCRIPTS = ("train", "evaluate", "serve", "export")


@pytest.mark.parametrize("command", CONSOLE_SCRIPTS)
def test_console_script_help(command, capsys):
    """pyproject.toml names dip-torch-{command} -> _cli:{command}, and
    each entry's --help exits 0."""
    text = (REPO / "pyproject.toml").read_text()
    line = (f'dip-torch-{command} = "deepinpainting_torch._cli:'
            f'{command}"')
    assert line in text
    from deepinpainting_torch import _cli
    with pytest.raises(SystemExit) as exit_info:
        getattr(_cli, command)(["--help"])
    assert exit_info.value.code == 0
    assert "usage" in capsys.readouterr().out


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
