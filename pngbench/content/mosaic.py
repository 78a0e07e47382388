"""Frames as mosaics of tiles: `bank_calls` x `batch` frames of
height x width, each a mosaic of the 40 synthetic tiles of side `tile`
(pngbench/tiles.py:mosaic_batch) in its own arrangement, drawn from a
fixed seed, so every run holds the same frames."""

import numpy as np

from pngbench import tiles

ARRANGEMENT_SEED = 0x4B4B


def units(config: dict, channels: int):
    bank = tiles.bank(channels, config["tile"], tiles.N_CLASSES)
    n = config["bank_calls"] * config["batch"]
    return tiles.mosaic_batch(bank, n, config["height"], config["width"],
                              np.random.default_rng(ARRANGEMENT_SEED))
