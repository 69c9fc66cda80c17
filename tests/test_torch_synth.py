"""The port's synthetic dataset (deepinpainting_torch/data/synth.py)
against the JAX repository's scripts/make_synth_data.py, run as the
recorded protocols ran it, in a subprocess: the same arguments write the
same files, byte for byte; demo.make_data writes them in process."""

import subprocess
import sys
from pathlib import Path

import pytest

from deepinpainting_torch import demo
from deepinpainting_torch.data import synth

REPO = Path(__file__).resolve().parent.parent
SCRIPT = REPO / "scripts" / "make_synth_data.py"


def tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def script_tree(out: Path, args) -> dict:
    res = subprocess.run([sys.executable, str(SCRIPT), "--out", str(out),
                          *args], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    return tree(out)


@pytest.mark.parametrize("args", [
    ("--n", "3", "--n_valid", "2", "--n_masks", "3", "--size", "48"),
    ("--n", "2", "--n_valid", "1", "--n_masks", "4", "--size", "64",
     "--seed", "7"),
])
def test_synth_writes_the_scripts_bytes(tmp_path, args):
    want = script_tree(tmp_path / "script", args)
    synth.main(["--out", str(tmp_path / "port"), *args])
    got = tree(tmp_path / "port")
    assert sorted(got) == sorted(want)
    n = dict(zip(args[::2], args[1::2]))
    assert len(want) == (int(n["--n"]) + int(n["--n_valid"])
                         + int(n["--n_masks"]))
    assert got == want


def test_make_data_writes_in_process_what_the_script_writes(
        tmp_path, monkeypatch):
    args = ("--n", "2", "--n_valid", "2", "--n_masks", "2", "--size", "40")
    ran = []
    monkeypatch.setattr(subprocess, "run",
                        lambda *a, **k: ran.append(a) or None)
    monkeypatch.setattr(subprocess, "Popen",
                        lambda *a, **k: ran.append(a) or None)
    data, seconds = demo.make_data(tmp_path / "demo", args)
    assert not ran and seconds > 0
    monkeypatch.undo()
    assert tree(data) == script_tree(tmp_path / "script", args)
    # a second call finds the directory in place
    assert demo.make_data(tmp_path / "demo", args) == (data, 0.0)
