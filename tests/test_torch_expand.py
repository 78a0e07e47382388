"""fpng_tpu_torch's B5 deposit and B6 expansion against fpng_tpu's, on the
CPU.

expand_plain must equal fpng_tpu.ops.specdec_tpu.expand_tpu (Pallas in
interpret mode) on seeded slot rasters, and scatter_packed16_plain must
equal scatter_packed16_tpu(wide=True) on seeded monotone records; the
port's raster is unpadded (h x w*c slots) where the TPU pads rows to
bpl_pad slots and the image to H8 rows, so the TPU raster is cut to the
first h rows and bpl slots.  Tolerance zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpng_tpu.ops.bitpack import scatter_packed16_tpu
from fpng_tpu.ops.specdec_tpu import _bpl_pad, expand_tpu
from fpng_tpu_torch.ops import expand as expand_mod
from fpng_tpu_torch.ops.bitpack import scatter_packed16, scatter_packed16_plain
from fpng_tpu_torch.ops.expand import expand, expand_plain


@pytest.mark.parametrize("c,h,w", [
    (3, 13, 6),    # skinny rows: 18 slots, unpadded on the TPU too
    (3, 11, 90),   # 270 slots, padded to 512 on the TPU
    (4, 5, 9),
    (4, 9, 70),    # 280 slots -> 512
])
def test_expand_matches_jax(c, h, w):
    rng = np.random.default_rng(100 * c + h)
    B = 2
    bpl, bpl_pad = w * c, _bpl_pad(w * c)
    H8 = -(-h // 8) * 8
    # random slot words: values, literal flags and junk in the high bits;
    # about a third of the slots are matches (no literal bit)
    slots = rng.integers(0, 1 << 16, (B, H8, bpl_pad), dtype=np.uint32)
    slots &= np.where(rng.random((B, H8, bpl_pad)) < 0.35, 0xFEFF,
                      0xFFFF).astype(np.uint32)
    slots = slots.astype(np.uint16)
    want = np.asarray(expand_tpu(
        jnp.asarray(slots.view(np.int32).reshape(B, -1)), h=h, w=w, c=c,
        bpl_pad=bpl_pad, interpret=True))
    raster = torch.from_numpy(
        np.ascontiguousarray(slots[:, :h, :bpl]).view(np.int16)
        .reshape(B, h * bpl))
    got = expand_plain(raster, h=h, w=w, c=c)
    assert got.dtype == torch.uint8 and got.shape == (B, h, w, c)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(expand(raster, h=h, w=w, c=c), got)


def _records(rng, B, n, n_slots):
    """Monotone wide records over distinct slots: a literal, a literal pair
    (slot and slot + 1) or a gap (value 0)."""
    meta = np.zeros((B, n), np.int32)
    metb = np.zeros((B, n), np.int32)
    for b in range(B):
        s = 0
        for i in range(n):
            kind = rng.integers(0, 3)
            meta[b, i] = min(s, n_slots)
            if kind and s + kind <= n_slots:
                v1, v2 = rng.integers(0, 256, 2)
                metb[b, i] = (0x100 | v1) | ((0x100 | v2) << 16 if kind == 2
                                             else 0)
                s += kind
            s += int(rng.integers(0, 4))
    return meta, metb


@pytest.mark.parametrize("n,n_slots", [(700, 1024), (3000, 2048)])
def test_scatter_packed16_matches_jax(n, n_slots):
    rng = np.random.default_rng(n)
    B = 2
    meta, metb = _records(rng, B, n, n_slots)
    dep = scatter_packed16_tpu(jnp.asarray(meta), n_slots // 2,
                               metb=jnp.asarray(metb), interpret=True,
                               wide=True)
    want = np.asarray(dep).view(np.uint16).reshape(B, n_slots)
    got = scatter_packed16_plain(torch.from_numpy(meta),
                                 torch.from_numpy(metb), n_slots)
    assert got.dtype == torch.int16
    assert np.array_equal(got.numpy().view(np.uint16), want)
    assert torch.equal(scatter_packed16(torch.from_numpy(meta),
                                        torch.from_numpy(metb), n_slots), got)


def test_scatter_packed16_drops_halves_outside_the_raster():
    meta = torch.tensor([[0, 5, 7, -1, 9]], dtype=torch.int32)
    metb = torch.tensor([[0x101, 0x1FF | (0x102 << 16), 0x103 | (0x104 << 16),
                          0x105, 0x106]], dtype=torch.int32)
    got = scatter_packed16_plain(meta, metb, 8)
    assert got.tolist() == [[0x101, 0, 0, 0, 0, 0x1FF, 0x102, 0x103]]


@pytest.mark.parametrize("h,bpl,want", [
    (256, 768, (16, 768, 16, 1)),       # the headline, 256 x 256 x 3
    (2160, 11520, (3, 3840, 720, 3)),   # 4K, 3 840 x 3
    (21, 39, (21, 39, 1, 1)),           # 21 x 13 x 3
    (1, 1 << 20, (1, 4096, 1, 256)),    # one row past any band
])
def test_expand_tiling(h, bpl, want):
    """B6's tiles: strips of at most 4096 slots (a multiple of 16 when a row
    is cut), bands of whole rows that fit 12288 slots, the raster covered."""
    R, S, bands, n_strips = expand_mod.tiling(h, bpl)
    assert (R, S, bands, n_strips) == want
    assert S <= 4096 and (n_strips == 1 or S % 16 == 0)
    assert R * (-(-S // 16) * 16) <= 12288 and R <= min(h, 256)
    assert (bands - 1) * R < h <= bands * R
    assert (n_strips - 1) * S < bpl <= n_strips * S


_RESET = 1 << 36


def _combine(left, right):
    """csrc/expand.cu:combine on Python ints."""
    if right & _RESET:
        return right
    vm = (right >> 32) & 0xF
    sel = sum(0xFF << (8 * k) for k in range(4) if vm >> k & 1)
    val = (right & sel) | (left & ~sel & 0xFFFFFFFF)
    return ((((left >> 32) | vm) & 0xF | (left >> 32) & 0x10) << 32) | val


def _tile_twin(raster, h, w, c, nt, tiles):
    """Python twin of kernel B6's decomposition: bands of R rows, strips of
    S slots with each row's fill carried across strips, each thread's run of
    a tile's slots joined by the segmented scan of _combine, column sums down
    the band plus the inclusive sum of the band above."""
    B, bpl = raster.shape[0], w * c
    R, S, bands, n_strips = tiles
    out = np.zeros((B, h, bpl), np.int64)
    for b in range(B):
        above = {}
        for j in range(bands):
            rows = min(R, h - j * R)
            carry = [0] * rows
            for s in range(n_strips):
                x0, Ss = s * S, min(S, bpl - s * S)
                sl = raster[b].reshape(h, bpl)[j * R:j * R + rows,
                                               x0:x0 + Ss].astype(np.int64)
                n, per = rows * Ss, -(-rows * Ss // nt) | 1  # odd runs

                def run(state, lo, hi, filled=None, ends=None):
                    for i in range(lo, hi):
                        r, x = divmod(i, Ss)
                        k = (x0 + x) % c
                        if x == 0:
                            state = carry[r] | _RESET
                        v = int(sl[r, x]) & 0xFFFF
                        if v & 0x100:
                            state = (state & ~(0xFF << 8 * k)) | \
                                (1 << 32 + k) | ((v & 0xFF) << 8 * k)
                        if filled is not None:
                            filled[r, x] = (state >> 8 * k) & 0xFF \
                                if state >> 32 + k & 1 else v & 0xFF
                            if x == Ss - 1:
                                ends[r] = state & ~_RESET
                    return state

                def summary(lo, hi):
                    # backwards from the run's end, as the kernel reads it
                    if lo == hi:
                        return 0
                    r, x = divmod(hi - 1, Ss)
                    k, found, state = (x0 + x) % c, set(), 0
                    while True:
                        v = int(sl[r, x]) & 0xFFFF
                        if v & 0x100 and k not in found:
                            state |= (1 << 32 + k) | ((v & 0xFF) << 8 * k)
                            found.add(k)
                        if x == 0 or len(found) == c or r * Ss + x == lo:
                            break
                        x, k = x - 1, (k - 1) % c
                    if x == 0:
                        for q in set(range(c)) - found:
                            if carry[r] >> 32 + q & 1:
                                state |= (1 << 32 + q) | \
                                    (carry[r] & 0xFF << 8 * q)
                    if lo % Ss == 0 or (hi - 1) // Ss != lo // Ss:
                        state |= _RESET
                    return state

                runs = [(min(t * per, n), min(t * per + per, n))
                        for t in range(nt)]
                sums = [summary(lo, hi) for lo, hi in runs]
                assert sums == [run(0, lo, hi) for lo, hi in runs]
                filled = np.zeros((rows, Ss), np.int64)
                ends = {}
                pre = 0  # the exclusive scan of the runs' summaries
                for (lo, hi), sm in zip(runs, sums):
                    run(pre, lo, hi, filled, ends)
                    pre = _combine(pre, sm)
                carry = [ends[r] for r in range(rows)]
                col = np.cumsum(filled, axis=0) + above.get(s, 0)
                above[s] = col[-1]
                out[b, j * R:j * R + rows, x0:x0 + Ss] = col
    return (out & 0xFF).astype(np.uint8).reshape(B, h, w, c)


@pytest.mark.parametrize("c,h,w,tiles", [
    (3, 21, 13, None),            # one band, one strip
    (4, 9, 70, None),
    (3, 40, 33, (3, 48, 14, 3)),  # bands of 3 rows, strips of 48
    (4, 7, 50, (2, 32, 4, 7)),    # strips that split pixels
    (3, 5, 1400, None),           # a row cut into two strips
])
def test_expand_tile_twin_matches_plain(c, h, w, tiles):
    rng = np.random.default_rng(c * h + w)
    B = 2
    raster = rng.integers(-(1 << 15), 1 << 15, (B, h * w * c)).astype(np.int16)
    raster[rng.random((B, h * w * c)) < 0.7] &= ~0x100
    tiles = tiles or expand_mod.tiling(h, w * c)
    want = expand_plain(torch.from_numpy(raster), h=h, w=w, c=c).numpy()
    assert np.array_equal(_tile_twin(raster, h, w, c, 16, tiles), want)


def test_expand_fills_at_slot_distance_c_then_defilters():
    """Row 0: literal 5 at x=0 of channel 0, a match to its end; row 1 adds
    a literal 1 at x=1 of channel 2."""
    h, w, c = 2, 3, 3
    s = np.zeros((1, h, w * c), np.int16)
    s[0, 0, 0] = 0x100 | 5
    s[0, 1, 5] = 0x100 | 1
    got = expand_plain(torch.from_numpy(s.reshape(1, -1)), h=h, w=w, c=c)
    assert got[0, 0].tolist() == [[5, 0, 0]] * 3
    assert got[0, 1].tolist() == [[5, 0, 0], [5, 0, 1], [5, 0, 1]]
