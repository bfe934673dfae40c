"""On the card: each cell at its own size with a short window comes out
correct, and its control (the program one precision below its
configuration) comes out not correct.  Skips without a card.

    python3 -m pytest port_bench/tests/test_bench_chip.py -q
"""

import json
import os
import subprocess
import sys

import pytest

from port_bench import harness

ROOT = os.path.dirname(harness.BENCH_DIR)
CELLS = [w["name"] for w in json.load(open(os.path.join(
    ROOT, "BENCHMARK.json")))["workloads"]]


def _line(*args):
    proc = subprocess.run([sys.executable, "-m", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_and_its_control(card, cell):
    run = ("--workload", cell, "--seed", "3000000023", "--seconds", "10")
    assert _line("port_bench.run", *run, "--trace", "0")["correct"] is True
    assert _line("port_bench.probe", "--probe", "control",
                 *run)["correct"] is False
