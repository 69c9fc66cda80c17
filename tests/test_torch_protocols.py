"""The port's quality protocols (deepinpainting_torch/demo.py) against the
JAX package's records of them.

  * every protocol's `_cli train` flags give the same Config in both
    packages' parsers, field by field, and the port's check_train_config
    takes it;
  * every JAX record in the table is the PSNR_average / SSIM_average line
    (or the table row) of the file and line it cites, so no band is typed
    by hand;
  * the band rule: inside passes, a miss on the first seed asks for the
    next, a miss on both makes report() return 1 naming the protocol, the
    figure, both seeds' values and the band; int8 and known replacement
    are judged as differences against the same checkpoint;
  * one tiny end-to-end run of the runner on the CPU (64 px, ngf 8, one
    step), for norm='batch' and for f32 with its extra evaluations.
"""

import argparse
import dataclasses
import math
import re
from pathlib import Path

import pytest

from deepinpainting_tpu import _cli as JCLI
from deepinpainting_tpu.config import Config as JConfig
from deepinpainting_torch import _cli as TCLI
from deepinpainting_torch import demo
from deepinpainting_torch.config import Config as TConfig
from deepinpainting_torch.engine.inpaint import check_train_config
from deepinpainting_torch.engine.schedules import lr_for_epoch

REPO = Path(__file__).resolve().parent.parent
PIECES = [(name, i) for name, p in demo.PROTOCOLS.items()
          for i in range(len(p.pieces))]
RECORDS = [(name, ev.name, i) for name, p in demo.PROTOCOLS.items()
           for ev in p.evaluations for i in range(len(ev.records))]
TINY = ("--fine_size", "64", "--ngf", "8", "--ndf", "8",
        "--vgg_width_scale", "0.125", "--batch_size", "2",
        "--data_workers", "0")


def _parse(add_flags, cls, argv):
    ap = argparse.ArgumentParser()
    add_flags(ap)
    args, _ = ap.parse_known_args(list(argv))
    return cls(**vars(args))


@pytest.mark.parametrize("name,piece", PIECES)
def test_protocol_flags_give_the_same_config(name, piece):
    proto = demo.PROTOCOLS[name]
    argv = demo.COMMON + proto.overrides + proto.pieces[piece]
    got = _parse(TCLI.add_config_flags, TConfig, argv)
    want = _parse(JCLI.add_config_flags, JConfig, argv)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert demo.train_config(argv) == got
    check_train_config(got)
    assert got.batch_size == 8 and got.debug_nan


def test_the_256_pieces_resume_on_one_schedule():
    """JAX's 256 px run stopped at epoch 30, resumed to 40 and resumed to
    60: three pieces on the 60-epoch schedule, each resuming from the last
    one's final checkpoint, which the save frequency writes."""
    proto = demo.PROTOCOLS["256"]
    argvs = [demo.COMMON + proto.overrides + p for p in proto.pieces]
    cfgs = [demo.train_config(a) for a in argvs]
    assert [demo.last_epoch(a) for a in argvs] == [30, 40, 60]
    assert all(c.niter == c.niter_decay == 30 for c in cfgs)
    assert [c.continue_train for c in cfgs] == [False, True, True]
    assert [c.which_epoch for c in cfgs[1:]] == ["30", "40"]
    assert all(e % cfgs[0].save_epoch_freq == 0 for e in (30, 40))
    assert demo.last_epoch(demo.COMMON) == 20


def test_stop_epoch_stops_on_the_schedule(tmp_path):
    """`_cli train --stop_epoch 1` of a 3-epoch schedule trains epoch 1
    and writes its checkpoint; a resume runs epochs 2 and 3, starting at
    the rate the checkpoint holds (epoch 1's, as a resumed JAX run does)
    and then following the 3-epoch schedule."""
    from PIL import Image
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    img, mask = tmp_path / "img", tmp_path / "mask"
    img.mkdir()
    mask.mkdir()
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
                        ).save(img / f"x{i}.png")
        m = np.zeros((64, 64, 3), np.uint8)
        m[16:40, 20:44] = 255
        Image.fromarray(m).save(mask / f"m{i}.png")
    argv = ["--dataroot", str(img), "--maskroot", str(mask), "--refroot",
            str(img), "--niter", "1", "--niter_decay", "2",
            "--save_epoch_freq", "1", "--checkpoints_dir",
            str(tmp_path / "ck"), "--name", "run", "--device", "cpu",
            *TINY]
    TCLI.train(argv + ["--stop_epoch", "1"])
    run = tmp_path / "ck" / "run"
    assert sorted(p.name for p in run.glob("epoch_*.pt")) == ["epoch_1.pt"]
    TCLI.train(argv + ["--continue_train", "true", "--which_epoch", "1"])
    assert sorted(p.name for p in run.glob("epoch_*.pt")) == [
        "epoch_1.pt", "epoch_2.pt", "epoch_3.pt"]
    cfg = demo.train_config(argv)
    want = {1: cfg.lr, 2: cfg.lr, 3: lr_for_epoch(cfg, 2)}
    for epoch, lr in want.items():
        sd = torch.load(run / f"epoch_{epoch}.pt", weights_only=True)
        assert {g["lr"] for k, v in sd.items() if k.startswith("opt_")
                for g in v["param_groups"]} == {lr}, epoch
    assert lr_for_epoch(cfg, 2) < cfg.lr


def _numbers(line):
    m = re.search(r"PSNR_average : ([\d.]+), SSIM_average : ([\d.]+)", line)
    if m:                                     # an evaluation's log
        return float(m.group(1)), float(m.group(2))
    cells = [c.strip() for c in line.strip().strip("|").split("|")]
    return float(cells[-2]), float(cells[-1])  # a markdown table row


@pytest.mark.parametrize("name,evaluation,index", RECORDS)
def test_record_is_the_line_it_cites(name, evaluation, index):
    ev = next(e for e in demo.PROTOCOLS[name].evaluations
              if e.name == evaluation)
    record = ev.records[index]
    path, line = record.source.rsplit(":", 1)
    text = (REPO / path).read_text().splitlines()[int(line) - 1]
    assert _numbers(text) == (record.psnr, record.ssim), text


def test_jax_kr_per_image_figures():
    """The known-replacement A/B's per-image figures that the docstring
    quotes (artifacts/kr_ablation/README.md): mean 0.017, largest 0.072."""
    logs = REPO / "artifacts" / "kr_ablation"
    true, false = (demo.per_image((logs / f"eval_faithful_e20_kr_{m}.log"
                                   ).read_text())[0]
                   for m in ("true", "false"))
    d = [abs(a - b) for a, b in zip(true, false)]
    assert len(d) == 32
    assert round(sum(d) / len(d), 3) == 0.017 and round(max(d), 3) == 0.072


def test_bands_follow_the_rule():
    got = demo.bands(demo.PROTOCOLS["f32"])
    assert got == {"psnr_e5": (24.53, 25.25), "ssim_e5": (0.722, 0.752),
                   "psnr_e20": (27.9, 28.25), "ssim_e20": (0.797, 0.832),
                   "d_psnr_e20_kr": (-0.14, 0.14),
                   "d_psnr_e20_int8": (-0.14, None),
                   "d_ssim_e20_int8": (-0.007, None)}
    # the port's first recorded f32 runs (SSIM 0.8153 / 0.8151) are inside
    assert got["ssim_e20"][0] <= 0.8151 <= 0.8153 <= got["ssim_e20"][1]
    q = demo.bands(demo.PROTOCOLS["256"])
    assert q["d_psnr_e60_int8"] == (-0.2, None)
    assert q["d_ssim_e60_int8"] == (-0.023, None)
    for name, proto in demo.PROTOCOLS.items():
        band = demo.bands(proto)
        for ev in proto.evaluations:
            if ev.kind == "abs":
                lo, hi = band[f"ssim_{ev.name}"]
                assert hi - lo == pytest.approx(
                    max(r.ssim for r in ev.records)
                    - min(r.ssim for r in ev.records) + 0.022), name


def _inside(proto, seed=0):
    """Figures at the low end of every band of `proto`."""
    return dict({k: lo for k, (lo, _) in demo.bands(proto).items()},
                seed=seed)


def test_inside_passes_and_a_miss_names_itself(capsys):
    proto = demo.PROTOCOLS["bf16"]
    inside = _inside(proto)
    assert demo.judge(proto, inside) == []
    low = dict(inside, ssim_e5=inside["ssim_e5"] - 1e-4)
    assert demo.judge(proto, low) == ["ssim_e5"]
    assert demo.judge(proto, {"seed": 0}) == list(demo.bands(proto))
    assert demo.report({"bf16": [inside]}) == 0
    assert demo.report({"bf16": [low, dict(inside, seed=1)]}) == 0
    capsys.readouterr()
    assert demo.report({"bf16": [low, dict(low, seed=1)]}) == 1
    err = capsys.readouterr().err
    assert "MISS bf16 ssim_e5" in err
    assert "seed 0 " in err and "seed 1 " in err and "band (0.743" in err


def test_relative_figures_are_judged_as_differences():
    """int8 and known replacement are held as differences against the
    same checkpoint: an int8 PSNR far from every record passes while its
    difference to the f32 evaluation of the same run is in band, and a
    difference out of band fails whatever the absolute figures say."""
    proto = demo.PROTOCOLS["f32"]
    inside = _inside(proto)
    far = dict(inside, psnr_e20_int8=10.0, ssim_e20_int8=0.1)
    assert demo.judge(proto, far) == []
    assert demo.judge(proto, dict(inside, d_psnr_e20_int8=-0.15)) == [
        "d_psnr_e20_int8"]
    assert demo.judge(proto, dict(inside, d_psnr_e20_int8=5.0)) == []
    assert demo.judge(proto, dict(inside, d_psnr_e20_kr=0.15)) == [
        "d_psnr_e20_kr"]


def test_a_miss_on_the_first_seed_reruns_at_the_next(monkeypatch,
                                                     tmp_path, capsys):
    calls = []

    def fake(proto, out, seed, device, cut=None):
        calls.append((proto.name, seed))
        figures = _inside(proto, seed)
        if proto.name == "cosis" and seed == 3:
            figures["psnr_e20"] -= 1.0
        if proto.name == "bn":               # a miss on every seed
            figures["psnr_e5"] += 1.0
        return figures

    monkeypatch.setattr(demo, "run_protocol", fake)
    code = demo.main(["--out", str(tmp_path), "--protocol", "trunc",
                      "--protocol", "cosis", "--seed", "3",
                      "--device", "cpu"])
    assert code == 0
    assert calls == [("trunc", 3), ("cosis", 3), ("cosis", 4)]
    calls.clear()
    capsys.readouterr()
    assert demo.main(["--out", str(tmp_path), "--protocol", "bn",
                      "--device", "cpu"]) == 1
    assert calls == [("bn", 0), ("bn", 1)]
    assert "MISS bn psnr_e5" in capsys.readouterr().err
    calls.clear()
    demo.main(["--out", str(tmp_path), "--protocol", "all",
               "--device", "cpu"])
    assert [c for c in calls if c[1] == 0] == [(n, 0) for n in demo.ORDER]
    assert demo.ORDER[-1] == "256"


@pytest.fixture(scope="module")
def tiny_runs(tmp_path_factory):
    """The runner end to end on the CPU: bn and f32 (three evaluations,
    the int8 gap, a POST) at 64 px, ngf 8, one epoch of one step."""
    out = tmp_path_factory.mktemp("demo")
    cut = demo.Cut(("--n", "2", "--n_valid", "2", "--n_masks", "2",
                    "--size", "64"),
                   ("--niter", "1", "--niter_decay", "0",
                    "--save_epoch_freq", "1") + TINY)
    return out, {name: demo.run_protocol(demo.PROTOCOLS[name], out, 0,
                                         "cpu", cut)
                 for name in ("bn", "f32")}


def test_tiny_runs_end_to_end(tiny_runs):
    out, runs = tiny_runs
    bn, f32 = runs["bn"], runs["f32"]
    assert bn["data_s"] > 0 and f32["data_s"] == 0.0    # one dataset
    for fig in runs.values():
        assert fig["fine_size"] == 64 and fig["train_images"] == 2
        assert fig["launches_train"] == fig["launches_evaluate"] == {
            "scan_stream": 0, "kbar_build": 0}        # the CPU launches none
    assert set(bn) >= {"psnr_e20", "ssim_e20"} and "psnr_e5" not in bn
    for k in ("psnr_e20", "ssim_e20", "psnr_e20_kr", "psnr_e20_int8"):
        assert math.isfinite(f32[k]) and f32[f"images_{k[5:]}"
                                             if k.startswith("psnr")
                                             else "images_e20"] == 2
    for ev in ("e20_kr", "e20_int8"):
        assert f32[f"d_psnr_{ev}"] == f32[f"psnr_{ev}"] - f32["psnr_e20"]
        assert f32[f"d_ssim_{ev}"] == f32[f"ssim_{ev}"] - f32["ssim_e20"]
        assert 0 <= f32[f"max_abs_d_psnr_{ev}"] < 5
    gap = f32["fake_B_int8_gap"]
    assert gap["images"] == 2 and 0 < gap["mean_d"] <= gap["max_d"]
    assert f32["served_ok"] and f32["served"]["result_size"] == [64, 64]
    # each evaluation's log in JAX's format; every checkpoint deleted
    text = (out / "logs" / "f32_seed0.eval_e20_int8.log").read_text()
    psnr, ssim = demo.per_image(text)
    assert len(psnr) == len(ssim) == 2
    assert "PSNR_average" in text
    assert not list((out / "checkpoints").rglob("epoch_*.pt"))
    assert (out / "checkpoints" / "bn_seed0" / "config.json").exists()


def test_tiny_bn_run_trains_batch_norm(tiny_runs):
    out, _ = tiny_runs
    cfg = TConfig.load(str(out / "checkpoints" / "bn_seed0" / "config.json"))
    assert cfg.norm == "batch" and cfg.ngf == 8 and cfg.fine_size == 64
    cfg = TConfig.load(str(out / "checkpoints" / "f32_seed0" / "config.json"))
    assert cfg.norm == "instance" and cfg.dtype == "float32"
    assert cfg.attention_impl == "pallas"


def test_pieces_resume_and_evaluate_as_they_go(tmp_path, monkeypatch,
                                               capsys):
    """A protocol in three pieces, as `256` runs (stop, resume, resume) at
    the tiny size: each evaluation runs once the piece that reaches its
    epoch has trained, the int8 one against its base, and no checkpoint
    outlives the run."""
    monkeypatch.setitem(demo.DATA, "tiny", (
        "--n", "2", "--n_valid", "2", "--n_masks", "2", "--size", "64"))
    rec = demo.Record(0.0, 0.0, "")
    proto = demo.Protocol(
        "pieces", ("--niter", "1", "--niter_decay", "2",
                   "--save_epoch_freq", "1") + TINY, (
            demo.Evaluation("e1", 1, (rec,)),
            demo.Evaluation("e3", 3, (rec,)),
            demo.Evaluation("e3_int8", 3, (rec, rec), ("--quant", "int8"),
                            kind="int8", base="e3")),
        data="tiny",
        pieces=(("--stop_epoch", "1"),
                ("--continue_train", "true", "--which_epoch", "1",
                 "--stop_epoch", "2"),
                ("--continue_train", "true", "--which_epoch", "2")))
    fig = demo.run_protocol(proto, tmp_path, 0, "cpu")
    out = capsys.readouterr().out
    order = [m.group(1) or m.group(2) for m in re.finditer(
        r"^\[demo\] pieces_seed0(?:: trained epochs (\S+),| (e\w+) \()",
        out, re.MULTILINE)]
    assert order == ["1-1", "e1", "2-2", "3-3", "e3", "e3_int8"], out
    assert fig["train_images"] == 3 * 2 and fig["epochs"] == 3
    assert fig["d_psnr_e3_int8"] == fig["psnr_e3_int8"] - fig["psnr_e3"]
    assert not list(tmp_path.rglob("epoch_*.pt"))
    assert sorted(p.name for p in (tmp_path / "logs").iterdir()) == [
        f"pieces_seed0.{x}" for x in (
            "eval_e1.log", "eval_e3.log", "eval_e3_int8.log", "metrics.csv",
            "train0.log", "train1.log", "train2.log")]


def test_a_run_after_another_in_one_process_equals_it_alone(tiny_runs,
                                                           tmp_path):
    """`demo.py` trains its protocols one after another in one process:
    f32 after bn there gives the losses of f32 in a fresh process, so no
    state carries from one run into the next.  Within 1e-6 relative, not
    to the last bit: in about half of the runs under pytest-xdist the
    fresh process's G_GAN, D, F and cosis came out 1-2e-7 relative away
    (its G_L1 equal); a carried mode, generator or statistic moves them
    by far more."""
    import numpy as np
    import subprocess
    import sys
    out, _ = tiny_runs
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from deepinpainting_torch import demo\n"
        "cut = demo.Cut(('--n', '2', '--n_valid', '2', '--n_masks', '2',\n"
        "                '--size', '64'), ('--niter', '1', '--niter_decay',\n"
        f"               '0', '--save_epoch_freq', '1') + {TINY!r})\n"
        "demo.run_protocol(demo.PROTOCOLS['f32'], Path(sys.argv[1]), 0,\n"
        "                  'cpu', cut)\n")
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]

    def losses(root):
        rows = (root / "logs" / "f32_seed0.metrics.csv").read_text(
            ).splitlines()
        cells = [r.split(",") for r in rows[1:]]      # less the time
        return rows[0], [[float(v) for v in c[:1] + c[2:]] for c in cells]

    (head, got), (want_head, want) = losses(tmp_path), losses(out)
    assert head == want_head and len(got) == len(want) > 0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_jax_512_ssim_records_exceed_one():
    """JAX's 512 px averages (0.997 / 0.991) hold per-image SSIM above 1,
    which a correct SSIM cannot reach; the in-range images average 0.80 /
    0.84, what the port's full-f32 SSIM is compared with (PERF.md)."""
    logs = REPO / "artifacts" / "train512"
    for ep, above, mean_in in (("05", 8, 0.80), ("20", 9, 0.84)):
        _, ssim = demo.per_image((logs / f"eval512_e{ep}.log").read_text())
        high = [v for v in ssim if v > 1]
        rest = [v for v in ssim if v <= 1]
        assert len(ssim) == 32 and len(high) == above and max(high) < 2.6
        assert round(sum(rest) / len(rest), 2) == mean_in
