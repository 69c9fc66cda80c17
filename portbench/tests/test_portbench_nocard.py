"""The measurement path fails, and does not fall back to the CPU, where
there is no card; the command prints no result then."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import harness


def _no_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            json.loads(line)
            return False
        except ValueError:
            pass
    return True


def test_run_exits_without_a_result_when_no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "train-256-f32", "--seed", str(2**31 + 9),
                          "--seconds", "1", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert _no_result(out.stdout)


def test_harness_raises_for_a_cuda_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        harness.run_cell(harness.load_cell("serve-256-f32-sat"), 1, 1.0,
                         False, "cuda")


def test_run_fails_without_the_program(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark."""
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.'); "
            "from portbench import harness; "
            "harness.run_cell(harness.load_cell('train-256-f32'), 1, 1.0, "
            "False, 'cpu')")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})
    assert out.returncode != 0
    assert "deepinpainting_torch" in out.stderr
    assert _no_result(out.stdout)
