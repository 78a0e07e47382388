"""Map tiles: `bank_calls` x `batch` distinct tiles of the 40 synthetic
classes (pngbench/tiles.py:bank, its own fixed seed), a content call
each `batch` of them in turn.  Every call holds every class three or more
times, and no two calls hold the same tile."""

from pngbench import tiles


def units(config: dict, channels: int):
    n = config["bank_calls"] * config["batch"]
    return tiles.bank(channels, config["tile"], n)
