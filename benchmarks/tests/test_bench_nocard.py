"""Without the card the run measures nothing: no result, a non-zero exit.
An unknown card is refused too."""

import subprocess
import sys

import pytest

from benchmarks import peaks
from benchmarks.tests.conftest import REPO


def test_no_card_no_result(cuda_absent):
    p = subprocess.run(
        [sys.executable, "-m", "benchmarks.run", "--workload",
         "gan_train_jpeg", "--seed", "3000000007", "--seconds", "1",
         "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "refused" in p.stderr


@pytest.fixture
def cuda_absent():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")


def test_unknown_card_is_refused():
    with pytest.raises(peaks.UnknownCard):
        peaks.peaks("NVIDIA H100 PCIe")
    assert peaks.peaks("NVIDIA H100 80GB HBM3")["bf16"] == 989e12


def test_unknown_cell_is_an_error():
    p = subprocess.run(
        [sys.executable, "-m", "benchmarks.run", "--workload", "nothing",
         "--seed", "1", "--seconds", "1"], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_host_report_counts_this_process():
    from benchmarks import host
    a = host.reading()
    sum(i * i for i in range(2_000_000))
    line = host.report(a, host.reading(), 24)
    assert line.startswith("host: ") and "MainThread" in line
    assert host.report({}, a, 24) == "host: not read"
