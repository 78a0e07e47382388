"""Parallel variable-length bitstream packing (counterpart of
fpng_tpu/ops/bitpack.py).

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
                 offsets: torch.Tensor, num_words: int) -> torch.Tensor:
    """Monotone bit deposit: the wrapper of kernel B10 (csrc/deposit.cu).

    Same contract as scatter_bits, on every word: words that no unit
    touches are zero.  A CPU tensor takes scatter_bits; a CUDA tensor
    launches the kernel (int32 vals and offsets) or raises.
    """
    if vals.device.type == "cpu":
        return scatter_bits(vals, nbits, offsets, num_words)
    K.require_cuda("deposit_bits", vals, offsets)
    if vals.dim() != 2 or offsets.shape != vals.shape:
        raise ValueError("deposit_bits: vals and offsets must be (B, N)")
    B, N = vals.shape
    if N >= 1 << 31 or num_words >= 1 << 31:
        raise ValueError("deposit_bits: sizes past int32")
    words = torch.zeros((B, num_words), dtype=torch.int32, device=vals.device)
    K.check(K.lib().fpng_deposit(
        vals.data_ptr(), offsets.data_ptr(), B, N, num_words,
        words.data_ptr(), K.stream_ptr(vals.device)), "fpng_deposit")
    deposit_bits.launches += 1
    return words


deposit_bits.launches = 0
