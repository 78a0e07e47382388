"""Parallel variable-length bitstream packing and the decoder's literal
deposit (counterpart of fpng_tpu/ops/bitpack.py).

The reference's sequential 64-bit accumulator (PUT_BITS*, fpng.cpp:564-588)
becomes per-unit (value, nbits) pairs -> exclusive prefix sum of nbits ->
each unit's bits split into (word, word + 1) contributions -> a deposit into
little-endian 32-bit words.

Words travel as int32 tensors holding the uint32 bit pattern: torch's
uint32 lacks shifts, comparisons and scatters on the CPU, so the plain code
computes in int64 masked to 32 bits and converts at the edges.
"""

from __future__ import annotations

import torch

from .. import kernels as K

MASK32 = 0xFFFFFFFF


def to_word32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same bit pattern."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def from_word32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2^32)."""
    return x.to(torch.int64) & MASK32


def exclusive_offsets(nbits: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """Per-unit start bit offsets: base + exclusive cumsum along axis 1."""
    nbits = nbits.to(torch.int64)
    return base.to(torch.int64)[:, None] + (torch.cumsum(nbits, dim=1) - nbits)


def scatter_bits(vals: torch.Tensor, nbits: torch.Tensor,
                 offsets: torch.Tensor, num_words: int) -> torch.Tensor:
    """Pack (B, N) units into (B, num_words) little-endian words (int32).

    The plain version of the deposit: two scatter-adds.  vals hold at most
    `nbits` significant bits (nbits itself is not read); offsets are
    absolute bit positions.  Words past num_words are dropped.
    """
    vals = vals.to(torch.int64) & MASK32
    offsets = offsets.to(torch.int64)
    word = offsets >> 5
    sh = offsets & 31
    lo = (vals << sh) & MASK32
    hi = (vals >> 1) >> (31 - sh)  # avoids a shift by 32
    # column num_words collects the dropped contributions
    out = torch.zeros((vals.shape[0], num_words + 1), dtype=torch.int64,
                      device=vals.device)
    out.scatter_add_(1, word.clamp(max=num_words), lo)
    out.scatter_add_(1, (word + 1).clamp(max=num_words), hi)
    return to_word32(out[:, :num_words] & MASK32)


def deposit_bits(vals: torch.Tensor, nbits: torch.Tensor,
                 offsets: torch.Tensor, num_words: int, *,
                 shift: int = 0) -> torch.Tensor:
    """Monotone bit deposit: the wrapper of kernel B10 (csrc/deposit.cu).

    The contract of scatter_bits at bit offsets `offsets << shift`, on
    every word: words that no unit touches are zero.  The chunked decode
    passes int32 16-bit slot indices with shift=4, so its record offsets
    reach past 2^31 bits (a raster past 2^27 bytes) while each unit stays
    8 bytes.  A CPU tensor takes scatter_bits; a CUDA tensor launches the
    kernel (int32 vals and offsets) or raises.
    """
    if not 0 <= shift < 32:
        raise ValueError(f"deposit_bits: shift {shift} outside [0, 32)")
    if vals.device.type == "cpu":
        return scatter_bits(vals, nbits, offsets.to(torch.int64) << shift,
                            num_words)
    K.require_cuda("deposit_bits", vals, offsets)
    if vals.dim() != 2 or offsets.shape != vals.shape:
        raise ValueError("deposit_bits: vals and offsets must be (B, N)")
    B, N = vals.shape
    if N >= 1 << 31:
        raise ValueError("deposit_bits: more than 2^31 units an image")
    words = torch.zeros((B, num_words), dtype=torch.int32, device=vals.device)
    K.check(K.lib().fpng_deposit(
        vals.data_ptr(), offsets.data_ptr(), shift, B, N, num_words,
        words.data_ptr(), K.stream_ptr(vals.device)), "fpng_deposit")
    deposit_bits.launches += 1
    return words


deposit_bits.launches = 0


def scatter_packed16_plain(meta: torch.Tensor, metb: torch.Tensor,
                           n_slots: int) -> torch.Tensor:
    """Plain torch version of kernel B5 (same contract as
    scatter_packed16): two scatters into a zeroed raster whose two extra
    columns collect the records that deposit nothing."""
    B = meta.shape[0]
    slot = meta.reshape(B, -1).to(torch.int64)
    v = metb.reshape(B, -1).to(torch.int64) & MASK32
    lo, hi = v & 0xFFFF, v >> 16
    ok = slot >= 0
    out = torch.zeros((B, n_slots + 2), dtype=torch.int32, device=meta.device)
    out.scatter_(1, torch.where(ok & (lo != 0) & (slot < n_slots), slot,
                                n_slots), lo.to(torch.int32))
    out.scatter_(1, torch.where(ok & (hi != 0) & (slot + 1 < n_slots),
                                slot + 1, n_slots + 1), hi.to(torch.int32))
    return out[:, :n_slots].to(torch.int16)


def scatter_packed16(meta: torch.Tensor, metb: torch.Tensor,
                     n_slots: int) -> torch.Tensor:
    """Literal deposit into a 16-bit-slot raster: the wrapper of kernel B5
    (csrc/deposit.cu), which replaces fpng_tpu's scatter_packed16_tpu
    with its wide records.

    meta int32 slots and metb int32 values, (0x100 | v1) | (0x100 | v2)
    << 16 with 0 = gap, both (B, S, NC) as the finalize writes them (step
    major: a step's NC lanes contiguous, the kernel reads each lane's
    records as a run) or (B, N), taken as one step of N lanes.  The low
    half lands at `slot`, a non-zero high half at slot + 1; halves outside
    [0, n_slots) are dropped.  The slots that records fill must be
    distinct (the walk's literals are).  Returns a (B, n_slots) int16
    raster, zero where no literal landed.  A CPU tensor takes
    scatter_packed16_plain; a CUDA tensor launches the kernel (which
    zero-fills the raster first) or raises.
    """
    if meta.device.type == "cpu":
        return scatter_packed16_plain(meta, metb, n_slots)
    K.require_cuda("scatter_packed16", meta, metb)
    if meta.dim() not in (2, 3) or metb.shape != meta.shape:
        raise ValueError("scatter_packed16: meta and metb must be (B, S, NC) "
                         "or (B, N), of one shape")
    B = meta.shape[0]
    S, NC = meta.shape[1:] if meta.dim() == 3 else (1, meta.shape[1])
    if max(S, NC, n_slots) >= 1 << 31 or B > 65535:
        raise ValueError("scatter_packed16: sizes past int32, or more than "
                         "65535 images")
    raster = torch.empty((B, n_slots), dtype=torch.int16, device=meta.device)
    K.check(K.lib().fpng_scatter_packed16(
        meta.data_ptr(), metb.data_ptr(), B, S, NC, n_slots,
        raster.data_ptr(), K.stream_ptr(meta.device)),
        "fpng_scatter_packed16")
    scatter_packed16.launches += 1
    return raster


scatter_packed16.launches = 0
