"""The harness's model-family hook.  A stand-in family of another model
(plain torch: standin_program.py, standin_family.py) runs through
harness.run_cell on the CPU from new files only, in a temporary benchmark:
correct when sound, not correct with a loss or an answer altered where the
program produces it.  harness.py names no network or kernel of IPSR, and
the ipsr family's operations and kernel bounds are counts.py's."""

import ast
import json
import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import standin_program as SP
from portbench import counts, harness, images
from portbench import weights as W
from portbench.reference.step import feature_flags

TESTS = Path(__file__).resolve().parent
SEED = 2**31 + 4242
E2E = {"train": ("train_img_per_s", "img/s"), "serve": ("serve_img_per_s",
                                                        "img/s")}
PER_LAYER = {"train": [("data.wait_ms", "ms"), ("train.mfu", "%")],
             "serve": [("serve.batch_occupancy.sat", "req/call"),
                       ("serve.mfu", "%")]}
LIMITS = {"train": {"loss.step1": 1e-4, "grad1.worst_leaf": 1e-3,
                    "delta3.worst_leaf": 1e-2},
          "serve": {"u8.mean_levels": 0.5}}
TRAFFIC = {"train": {"kind": "train", "pool_batches": 4},
           "serve": {"kind": "closed", "clients": 4, "max_batch": 4,
                     "batch_wait_ms": 2.0, "pool": 16, "sample": 8}}
CELLS = {"standin-train": "train", "standin-serve": "serve"}


def _standin_bench(root: Path) -> Path:
    """BENCHMARK.json and the folder bench/ of a stand-in family's
    configuration, two cells and their readers, under `root`."""
    home = root / "bench"
    for kind in ("end_to_end", "metrics"):
        (home / kind).mkdir(parents=True)
    for kind, (name, _) in E2E.items():
        shutil.copy(harness.HERE / "end_to_end" / f"{name}.py",
                    home / "end_to_end")
        for metric, _ in PER_LAYER[kind]:
            shutil.copy(harness.HERE / "metrics" / f"{metric}.py",
                        home / "metrics")
    (home / "families").mkdir()
    shutil.copy(TESTS / "standin_family.py", home / "families" / "standin.py")
    files = {"configs/standin-32.json": {
        "family": "standin", "source": "a stand-in of the tests",
        "fine_size": 32, "batch_size": 4, "width": 8}}
    for cell, kind in CELLS.items():
        files[f"traffic/{kind}.json"] = TRAFFIC[kind]
        files[f"workloads/{cell}.json"] = {"config": "standin-32",
                                           "traffic": kind, "chips": 1,
                                           "limits": LIMITS[kind]}
    for rel, data in files.items():
        (home / rel).parent.mkdir(exist_ok=True)
        (home / rel).write_text(json.dumps(data))
    metric = lambda name, unit, kind, **kw: dict(
        name=name, unit=unit, better="higher", source="host_clock",
        workloads=[c for c, k in CELLS.items() if k == kind], **kw)
    bench = {
        "configs": [{"name": "standin-32", "file": "bench/configs/"
                     "standin-32.json", "reduced": []}],
        "workloads": [{"name": c, "config": "standin-32", "traffic": k,
                       "chips": 1} for c, k in CELLS.items()],
        "end_to_end": [metric(n, u, k, bound=0.05)
                       for k, (n, u) in E2E.items()]
        + [{"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
            "source": "host_clock"}],
        "per_layer": [metric(n, u, k, layer="stand-in", moves=E2E[k][0])
                      for k, ms in PER_LAYER.items() for n, u in ms]}
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return home


@pytest.fixture
def standin(tmp_path):
    home = _standin_bench(tmp_path)
    return lambda name: harness.load_cell(name, tmp_path / "BENCHMARK.json",
                                          home)


def _run(cell, traced=False):
    return harness.run_cell(cell, SEED, 1.0, traced, "cpu")


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("name", list(CELLS))
def test_standin_sound_run_is_correct(standin, name, traced):
    cell = standin(name)
    assert cell.family == "standin"
    harness.family_of(cell).check_cell(cell.config, cell.traffic["kind"],
                                       cell.limits)
    r = _run(cell, traced)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["checks"]) == set(LIMITS[CELLS[name]])
    kind = CELLS[name]
    want = [n for n, _ in PER_LAYER[kind]] if traced \
        else [E2E[kind][0], "setup_s"]
    assert set(r["metrics"]) == set(want)
    assert all(m["value"] > 0 for m in r["metrics"].values())


def test_standin_loss_altered_where_produced(standin, monkeypatch):
    real = SP.make_train_step

    def altered(cfg, dev):
        step = real(cfg, dev)

        def run(state, batch):
            state, m = step(state, batch)
            return state, dict(m, L1=m["L1"] * 1.01)
        return run
    monkeypatch.setattr(SP, "make_train_step", altered)
    r = _run(standin("standin-train"))
    assert not r["correct"]
    assert r["checks"]["loss.step1"]["value"] > 5e-3


def test_standin_answer_altered_where_produced(standin, monkeypatch):
    real = SP.make_serving_fn

    def altered(cfg, dev):
        serve = real(cfg, dev)
        return lambda coarse, image, mask: torch.clamp(
            serve(coarse, image, mask).int() + 2, 0, 255).to(torch.uint8)
    monkeypatch.setattr(SP, "make_serving_fn", altered)
    r = _run(standin("standin-serve"))
    assert not r["correct"]
    assert r["checks"]["u8.mean_levels"]["value"] > 1.5


def test_standin_power_iteration_needs_its_draw_rule(standin):
    """The default of a leaf no rule draws (0) would leave the critic's
    spectral estimate at 0 and its output not finite."""
    cell = standin("standin-train")
    fam = harness.family_of(cell)
    cfg = harness.program_config(cell)
    shapes = W.shapes_of(fam.networks(cfg, train=True))
    x = torch.zeros(1, 3, 32, 32)
    for rule, finite in ((fam.leaf_std(cfg), True),
                         (lambda net, key, shape: cfg.init_gain
                          if len(shape) == 4 else None, False)):
        w = W.draw(shapes, SEED, torch.device("cpu"), rule)
        critic = SP.Critic(cfg.width)
        critic.load_state_dict(w["critic"])
        y = critic(x, critic.iterate())
        assert bool(torch.isfinite(y).all()) == finite


# ---- the ipsr family ----------------------------------------------------------

IPSR_NAMES = {"G", "P", "D", "F", "vgg", "scan", "kbar"}


def _words(tree):
    """Every identifier, attribute, argument and string of a module, split
    into words at characters other than letters and digits and at '_'."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            yield node.id
        elif isinstance(node, ast.Attribute):
            yield node.attr
        elif isinstance(node, ast.arg):
            yield node.arg
        elif isinstance(node, ast.keyword) and node.arg:
            yield node.arg
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            yield node.name
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            yield from re.split(r"[^A-Za-z0-9]+", node.value)


def test_harness_names_no_network_or_kernel_of_ipsr():
    tree = ast.parse((harness.HERE / "harness.py").read_text())
    words = {p for w in _words(tree) for p in re.split(r"[_.]", w)}
    assert not words & IPSR_NAMES


def _masked(masks, cfg):
    _, flag = feature_flags(torch.as_tensor(masks > 0).float(),
                            cfg.threshold, cfg.mask_thred)
    return flag.sum(1).long().numpy()


@pytest.mark.parametrize("name", ["train-256-f32", "train-512-bf16",
                                  "serve-256-f32-sat"])
def test_ipsr_family_counts_are_counts_py(name):
    """Operations an image, the kernels' least seconds over a window and
    kernels.missing, at the configuration's own shapes."""
    cell = harness.load_cell(name)
    cfg = harness.program_config(cell)
    fam = harness.family_of(cell)
    kind = "train" if cell.traffic["kind"] == "train" else "serve"
    shapes = W.shapes_of(fam.networks(cfg, train=kind == "train"))
    count = counts.train_flops if kind == "train" else counts.serve_flops
    assert fam.flops(kind, shapes, cfg) == count(shapes, cfg.fine_size,
                                                 cfg.dtype)
    b, size = cfg.batch_size, cfg.fine_size
    n, c = (size // 8) ** 2, cfg.ngf * 8
    pool = {"mask": images.pool(SEED, 2 * b, size, "cpu")["mask"]}
    masked = _masked(pool["mask"], cfg)
    assert masked.min() > 0
    if kind == "train":
        rows = [slice(0, b), slice(b, 2 * b), slice(0, b)]
        w = harness.Window("train", 1.0, steps=3, rows=rows,
                           counters={"scan_launches": 6, "kbar_launches": 2})
        scan_s = sum(counts.scan_seconds(b * n, int(masked[r].sum()), c)
                     for r in rows)
        assert fam.bounds(w, cfg, pool, "cpu") == {
            "scan": 2 * scan_s, "kbar": 2 * counts.kbar_seconds(b, n)}
        assert fam.missing(w) == 1.0
    else:
        rows = [3, 5, 5, 2 * b - 1]
        w = harness.Window("serve", 1.0, rows=rows, counters={
            "batches_run": 4, "items_served": 4, "scan_launches": 4,
            "kbar_launches": 0})
        assert fam.bounds(w, cfg, pool, "cpu") == {"scan": sum(
            counts.scan_seconds(n, int(masked[i]), c) for i in rows)}
        assert fam.missing(w) == 0.0
