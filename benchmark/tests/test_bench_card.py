"""On the card (marker ``cuda``; skipped without one): each one-card cell
run by its command line for a short window prints a correct result with
every end-to-end metric it reports.

    python -m pytest benchmark/tests/test_bench_card.py -m cuda -q
"""

import json
import subprocess
import sys

import pytest

from benchmark import harness

pytestmark = pytest.mark.cuda
SPEC = harness.bench_spec()
ONE = sorted(w["name"] for w in SPEC["workloads"] if w["chips"] == 1)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("cell", ONE)
def test_cell_runs_correct(card, cell):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "4294967377", "--seconds", "3", "--trace", "0"], cwd=harness.ROOT,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    want = {m["name"] for m in harness.metrics_for(SPEC, cell, False)}
    assert set(res["metrics"]) == want
