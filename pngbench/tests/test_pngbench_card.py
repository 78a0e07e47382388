"""One short run of each cell on the card, as the benchmark's command runs
it: exit code 0 and a result line with every key (skips without a card)."""

import json
import subprocess
import sys

import pytest

from pngbench.tests.conftest import ROOT


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", [
    "tile_rgb.decode", "frame4k_rgb.decode", "tile_rgba.decode",
    "tile_rgb.encode"])
def test_cell_runs_on_the_card(card, bench, workload, trace):
    p = subprocess.run(
        [sys.executable, "-m", "pngbench.run", "--workload", workload,
         "--seed", str(2**31 + 3), "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(out)
    assert list(out)[-1] == "checks"
    dev = out["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    group = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in bench[group]
            if workload in m.get("workloads", [workload])}
    assert set(out["metrics"]) == want
    if trace:
        assert 0 < dev["busy_s"] <= dev["window_s"]
        assert out["breakdown"]["device_ops"]


def test_no_card_no_result():
    """Without a card (or with too few) a run exits non-zero and prints
    no result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    p = subprocess.run(
        [sys.executable, "-m", "pngbench.run", "--workload",
         "tile_rgb.decode", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout
