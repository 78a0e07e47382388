"""The chunked decode past 2^27 raster bytes, on the CPU.

A raster of 2^27 bytes or more gives record offsets past 2^31 bits (16 bits
a slot).  The chunked decode's record geometry (ops/specdec.record_offsets)
must keep them exact (int32 slots, shifted into 64-bit bit offsets), and
the deposit (scatter_bits, which deposit_bits runs for CPU tensors) must
place units past 2^31 bits.  The
raster itself is never allocated here: the offsets are checked on records
at the slots of a 1 x 6144 x 7680 x 3 raster, and the deposit on a sparse
case just past 2^31 bits.
"""

import numpy as np
import torch

from fpng_tpu_torch.ops.bitpack import deposit_bits
from fpng_tpu_torch.ops.specdec import record_offsets

H, W, C = 6144, 7680, 3
TOTAL = H * (1 + W * C)  # 141 563 904 slots, past 2^27


def test_record_offsets_are_exact_past_2_31_bits():
    """(B, ST, NC) slots near the raster's end -> lane-major slots whose
    bit offsets, 16 a slot, are exact past 2^31 with no int32 wrap; the
    word count covers them."""
    ST, NC = 3, 4
    slots = np.array([TOTAL - 1 - 5 * np.arange(ST * NC)[::-1]],
                     np.int64).reshape(1, ST, NC)
    slots[0, :, 0] = [0, 1, 2 ** 27 - 1]
    ro, shift, dep_words = record_offsets(
        torch.from_numpy(slots.astype(np.int32)), TOTAL)
    assert ro.dtype == torch.int32 and ro.shape == (1, ST * NC)
    bits = ro.to(torch.int64) << shift
    want = slots.transpose(0, 2, 1).reshape(1, -1) * 16
    assert np.array_equal(bits.numpy(), want)
    assert int(bits.max()) == 16 * (TOTAL - 1) > 2 ** 31
    assert dep_words == -(-(16 * (TOTAL + 1)) // 32) + 1
    assert dep_words * 32 >= 16 * TOTAL + 16


def test_scatter_bits_places_units_past_2_31_bits():
    """A sparse record stream whose slots straddle 2^27 (bit 2^31): each
    literal lands in its own 16-bit slot, the gaps stay zero."""
    base = 2 ** 27 - 3  # slots; bit offsets from 2^31 - 48
    slots = np.array([[5, base, base + 1, base + 3, base + 3, base + 6]])
    syms = np.array([[0x141, 0x17F, 0x100, 0x1AA, 0, 0x1FF]])
    nbits = np.where(syms != 0, 16, 0)
    ro, shift, _ = record_offsets(
        torch.from_numpy(slots.astype(np.int32))[:, None], int(base + 8))
    num_words = (base + 8) // 2
    words = deposit_bits(torch.from_numpy(syms.astype(np.int32)),
                         torch.from_numpy(nbits.astype(np.int32)), ro,
                         num_words, shift=shift)
    assert words.shape == (1, num_words)
    half = words.numpy().view(np.uint16)[0]
    want = {int(s): int(v) for s, v in zip(slots[0], syms[0]) if v}
    assert {int(i): int(half[i]) for i in np.flatnonzero(half)} == want
    assert max(want) * 16 >= 2 ** 31
