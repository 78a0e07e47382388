"""The traffic generator: each cell's pool is a function of the seed,
and every seed sends the same content calls, in its own orders."""

import numpy as np
import pytest

from pngbench import manifest, run, tiles
from pngbench.tests.conftest import FRAME, TILE, small

SEED = 2**31 + 5


@pytest.mark.parametrize("workload", [
    "tile_rgb.decode", "frame4k_rgb.decode", "tile_rgba.decode",
    "tile_rgb.encode"])
def test_pool_is_deterministic_for_a_seed(bench, workload):
    cell = manifest.cell(bench, workload)
    name = cell["workload"]["config"]
    cfg = small(name, **(FRAME if name == "frame4k" else TILE))
    def sent(seed):
        units, calls, _ = run.make_pool(cfg, cell["traffic"], seed)
        return [units[idx] for idx in calls]

    a, b, c = sent(SEED), sent(SEED), sent(SEED + 1)
    assert len(a) == cfg["pool_calls"]
    shape = (cfg["batch"], cfg["height"], cfg["width"],
             cell["traffic"]["channels"])
    assert all(x.shape == shape and x.dtype == np.uint8 for x in a)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))


def test_bank_is_the_ports_generator():
    from fpng_tpu_torch.train import synthetic_corpus

    for c in (3, 4):
        want = np.stack(list(synthetic_corpus(c, size=24)))
        assert np.array_equal(tiles.bank(c, 24, tiles.N_CLASSES), want)


@pytest.mark.parametrize("name,sizes", [("tile256", TILE),
                                        ("frame4k", FRAME)])
def test_every_seed_sends_the_same_calls(name, sizes):
    """Each group of `bank_calls` calls sends every content call once,
    whatever the seed; the calls differ in content from each other."""
    cfg = small(name, **sizes)
    traffic = {"channels": 3}
    B, P = cfg["batch"], cfg["bank_calls"]
    key = lambda x: tuple(sorted(t.tobytes() for t in x))  # noqa: E731
    units, calls, cycle = run.make_pool(cfg, traffic, 1)
    other, calls2, _ = run.make_pool(cfg, traffic, 2**40 + 3)
    assert cycle == P and len(units) == B * P
    assert np.array_equal(units, other)
    contents = {key(units[c * B:(c + 1) * B]) for c in range(P)}
    assert len(contents) == P
    for cs in (calls, calls2):
        for g in range(0, len(cs), P):
            assert {key(units[idx]) for idx in cs[g:g + P]} == contents
    assert any(not np.array_equal(a, b) for a, b in zip(calls, calls2))


def test_mosaic_places_every_tile_equally_often():
    bank = tiles.bank(3, 4, tiles.N_CLASSES)
    f = tiles.mosaic_batch(bank, 2, 22, 40, np.random.default_rng(4))
    assert f.shape == (2, 22, 40, 3)
    full = tiles.mosaic_batch(bank, 1, 24, 40 * 4, np.random.default_rng(5))
    cells = full[0].reshape(6, 4, 40, 4, 3).transpose(0, 2, 1, 3, 4)
    counts = {}
    for c in cells.reshape(-1, 4, 4, 3):
        counts[c.tobytes()] = counts.get(c.tobytes(), 0) + 1
    assert set(counts.values()) == {6}
