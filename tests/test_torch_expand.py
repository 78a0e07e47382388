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
