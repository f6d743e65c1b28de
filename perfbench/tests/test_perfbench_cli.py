"""The command's refusals: no result and a non-zero exit without a CUDA
card, and without the program beside the benchmark."""

import os
import shutil
import subprocess
import sys

from .conftest import REPO


def test_no_card_no_result(card_absent):
    done = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "d288_pair.strict",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert done.returncode != 0
    assert done.stdout.strip() == ""
    assert "CUDA" in done.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copytree(REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    code = ("from perfbench import harness; "
            "print(harness.run_cell('.', 'd288_pair.strict', 1, 0.1, False, "
            "device='cpu'))")
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    done = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode != 0
    assert done.stdout.strip() == ""
    assert "pcmi_tpu_torch" in done.stderr
