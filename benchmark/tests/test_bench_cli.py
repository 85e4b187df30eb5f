"""The command line: without as many CUDA devices as the cell asks for, or
in a directory that holds only ``BENCHMARK.json`` and the benchmark, it
exits non-zero and prints no result."""

import shutil
import subprocess
import sys

import pytest

from benchmark import harness

CELLS = sorted(w["name"] for w in harness.bench_spec()["workloads"])


def _cli(cwd, cell):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "4294967311", "--seconds", "1", "--trace", "0"], cwd=cwd,
        capture_output=True, text=True, timeout=300)


@pytest.fixture
def no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


@pytest.mark.parametrize("cell", CELLS)
def test_no_card_no_result(no_card, cell):
    out = _cli(harness.ROOT, cell)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path, CELLS[0])
    assert out.returncode != 0 and out.stdout.strip() == ""
