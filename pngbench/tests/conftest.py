"""The benchmark's own tests: the CPU runs them, and the card runs those
marked `card` (they skip without one):

    python -m pytest pngbench/tests -q
"""

import json
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def small(name: str, **sizes) -> dict:
    """A configuration of BENCHMARK.json cut to a size the CPU holds."""
    with open(os.path.join(ROOT, "pngbench", "configs", name + ".json")) as f:
        cfg = json.load(f)
    cfg.update(sizes)
    return cfg


TILE = dict(batch=4, bank_calls=2, height=32, width=32, tile=32,
            pool_calls=8)
FRAME = dict(batch=1, bank_calls=3, height=40, width=72, tile=16,
             pool_calls=3)
