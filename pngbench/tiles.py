"""The traffic's pixels: synthetic map tiles and 4K mosaics of them.

A frozen copy of the port's own corpus builders, so that later changes
to the program do not move the yardstick: `fpng_tpu_torch/train.py:
synthetic_corpus` (40 tile classes: flat blocks, gradients, photo-like
integrated noise, dithered noise, sprites, then twelve pairs of
integrated and multi-octave block noise) and `fpng_tpu_torch/bench.py:
make_corpus_4k` (frames as mosaics of those tiles).

`bank` runs the generator with its own fixed seed, cycling through the
40 classes for as many tiles as asked (its first 40 are synthetic_corpus's
own tiles); `mosaic_batch` arranges such tiles into frames.  The content
kinds of pngbench/content/ call them, and the run's seed draws only the
order of the calls (pngbench/run.py:make_pool).
"""

from __future__ import annotations

import numpy as np

N_CLASSES = 40
# class index -> kind, in synthetic_corpus's order and counts
KINDS = (["flat"] * 4 + ["gradient"] * 4 + ["photo"] * 4 + ["noise"] * 2
         + ["sprite"] * 2 + ["integrated", "octave"] * 12)


def _with_alpha(rgb, alpha, num_chans):
    if num_chans == 3:
        return rgb
    return np.concatenate([rgb, alpha[..., None]], axis=-1)


def make_tile(kind: str, num_chans: int, size: int,
              rng: np.random.Generator) -> np.ndarray:
    """One (size, size, num_chans) uint8 tile of `kind`, drawn from rng in
    synthetic_corpus's order of draws."""
    h = w = size
    opaque = np.full((h, w), 255, np.uint8)
    if kind == "flat":
        rgb = np.zeros((h, w, 3), np.uint8)
        rgb[:] = rng.integers(0, 256, 3, dtype=np.uint8)
        for _ in range(30):
            y0, x0 = rng.integers(0, h - 1), rng.integers(0, w - 1)
            y1, x1 = rng.integers(y0 + 1, h + 1), rng.integers(x0 + 1, w + 1)
            rgb[y0:y1, x0:x1] = rng.integers(0, 256, 3, dtype=np.uint8)
        alpha = opaque.copy()
        if num_chans == 4:
            for _ in range(8):
                y0, x0 = rng.integers(0, h - 1), rng.integers(0, w - 1)
                y1 = rng.integers(y0 + 1, h + 1)
                x1 = rng.integers(x0 + 1, w + 1)
                alpha[y0:y1, x0:x1] = rng.integers(0, 256, dtype=np.uint8)
        return _with_alpha(rgb, alpha, num_chans)
    if kind == "gradient":
        gy = np.linspace(0, rng.integers(64, 256), h)[:, None]
        gx = np.linspace(0, rng.integers(64, 256), w)[None, :]
        base = (gy + gx)[..., None] * rng.uniform(0.3, 1.0, 3)[None, None, :]
        rgb = (base % 256).astype(np.uint8)
        alpha = np.clip(gy + gx, 0, 255).astype(np.uint8)
        return _with_alpha(rgb, alpha if num_chans == 4 else opaque,
                           num_chans)
    if kind in ("photo", "integrated"):
        r = 6 if kind == "photo" else 3
        steps = rng.integers(-r, r + 1, (h, w, 3)).cumsum(axis=0).cumsum(
            axis=1)
        return _with_alpha((steps % 256).astype(np.uint8), opaque, num_chans)
    if kind == "noise":
        amp = int(rng.integers(8, 128))
        rgb = (rng.integers(0, amp, (h, w, 3)) * (256 // max(amp, 1))
               % 256).astype(np.uint8)
        alpha = rng.integers(200, 256, (h, w)).astype(np.uint8)
        return _with_alpha(rgb, alpha, num_chans)
    if kind == "sprite":
        palette = rng.integers(0, 256, (4, 3), dtype=np.uint8)
        idx = (rng.random((h, w)) < 0.15).astype(np.uint8)
        idx = np.maximum(idx, np.roll(idx, 1, axis=1))
        rgb = palette[idx * rng.integers(1, 4)]
        alpha = np.where(idx > 0, 255, 0).astype(np.uint8)
        return _with_alpha(rgb, alpha, num_chans)
    if kind == "octave":
        img = np.zeros((h, w, 3), np.float64)
        for octave, amp in ((4, 120), (16, 60), (64, 30)):
            g = rng.random((octave, octave, 3)) * amp
            rep = (h + octave - 1) // octave
            img += np.kron(g, np.ones((rep, rep, 1)))[:h, :w]
        rgb = (img % 256).astype(np.uint8)
        alpha = np.minimum(rgb[..., 0].astype(np.int32) + 120,
                           255).astype(np.uint8)
        return _with_alpha(rgb, alpha if num_chans == 4 else opaque,
                           num_chans)
    raise ValueError(f"unknown tile kind {kind!r}")


def bank(num_chans: int, size: int, n: int) -> np.ndarray:
    """(n, size, size, num_chans) tiles: synthetic_corpus's generator with
    its own seed, its 40 classes in turn (each n // 40 or n // 40 + 1
    times)."""
    rng = np.random.default_rng(0xF9C6 + num_chans)
    return np.stack([make_tile(KINDS[i % N_CLASSES], num_chans, size, rng)
                     for i in range(n)])


def mosaic_batch(tiles: np.ndarray, batch: int, height: int, width: int,
                 rng: np.random.Generator) -> np.ndarray:
    """(batch, height, width, C) frames, each a mosaic of the bank's tiles
    cropped to the frame, as make_corpus_4k builds its frames; each frame
    places every tile equally often (within one), in an arrangement drawn
    from rng."""
    size = tiles.shape[1]
    rows, cols = -(-height // size), -(-width // size)
    out = []
    for _ in range(batch):
        picks = rng.permutation(np.arange(rows * cols) % len(tiles))
        grid = tiles[picks].reshape(rows, cols, *tiles.shape[1:])
        frame = grid.transpose(0, 2, 1, 3, 4).reshape(
            rows * size, cols * size, tiles.shape[3])
        out.append(frame[:height, :width])
    return np.stack(out)
