"""Fused encoder deposit: desc -> (table lookup, bit offsets, deposit)
(counterpart of fpng_tpu/ops/encfuse.py).

One packed descriptor per unit of the token stream, plus the image's
288-entry code table packed as code | size << 16:

  desc bits:  0-8   sym        table index (literal byte / len sym / 0|2
                               filter / 256 EOB)
              9     use_table  0 => raw unit (header pending-tail bits)
              10-12 extra_n    trailing bit count (len-extra + 1-bit dist
                               code for matches; pending nacc for raw)
              13-25 extra_val  trailing bit value
              26    tok_start  reference flush-rule token starts

encode_bits_fused wraps kernel B1 (csrc/encfuse.cu), one launch that reads
desc once and writes every word once; encode_bits_plain is its plain
version, the materialize -> offsets -> scatter chain.
demote_mask wraps kernel B7 (csrc/demote.cu), the 32 bpp 1-pass cost
check; demote_mask_plain is its plain version.
"""

from __future__ import annotations

import torch

from .. import kernels as K
from .bitpack import MASK32, exclusive_offsets, scatter_bits

DESC_SYM_BITS = 9
DESC_USE_TABLE = 1 << 9
DESC_EXTRA_N_SHIFT = 10
DESC_EXTRA_VAL_SHIFT = 13
DESC_TOK_START = 1 << 26

_TILE = 4096  # units a tile of the kernel (kEncTile in csrc/encfuse.cu)
_SLOT_BYTES = 24  # a tile's published run (Slot in csrc/encfuse.cu)
_MAX_BASE_BITS = 1 << 16  # base_bits bound: a header prefix is < 640 bytes


def pack_table(codes: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    """(B, 288) codes/sizes -> (B, 8, 128) int32 code | size << 16 tiles."""
    B = codes.shape[0]
    packed = codes.to(torch.int64) | (sizes.to(torch.int64) << 16)
    out = torch.zeros((B, 1024), dtype=torch.int32, device=codes.device)
    out[:, :packed.shape[1]] = packed.to(torch.int32)
    return out.reshape(B, 8, 128)


def materialize_units(desc: torch.Tensor, codes: torch.Tensor,
                      sizes: torch.Tensor):
    """Per-unit decode of the desc stream.

    desc (B, N) int32; codes/sizes (B, S) code table.  Returns (vals int64
    holding uint32 values, nbits int64, tok_start bool), each (B, N).
    """
    d = desc.to(torch.int64)
    sym = d & 511
    use_t = ((d >> 9) & 1) == 1
    en = (d >> DESC_EXTRA_N_SHIFT) & 7
    ev = (d >> DESC_EXTRA_VAL_SHIFT) & 0x1FFF
    ts = ((d >> 26) & 1) == 1
    code = torch.gather(codes.to(torch.int64), 1, sym)
    sz = torch.gather(sizes.to(torch.int64), 1, sym)
    sz = torch.where(use_t, sz, 0)
    code = torch.where(use_t, code, 0)
    vals = (code | (ev << sz)) & MASK32
    return vals, sz + en, ts


def encode_bits_plain(desc: torch.Tensor, tbl: torch.Tensor,
                      base_bits: torch.Tensor, num_words: int):
    """Plain version of kernel B1: materialize_units + exclusive_offsets +
    scatter_bits.  Returns (words (B, num_words) int32, total_bits (B,)
    int64, last_tok (B,) int64)."""
    B = desc.shape[0]
    t = tbl.reshape(B, -1).to(torch.int64)
    vals, nbits, ts = materialize_units(desc, t & 0xFFFF, t >> 16)
    offsets = exclusive_offsets(nbits, base_bits)
    words = scatter_bits(vals, nbits, offsets, num_words)
    total = offsets[:, -1] + nbits[:, -1]
    last_tok = torch.where(ts, offsets, -1).max(dim=1).values
    return words, total, last_tok


def _scratch_bytes(B: int, N: int) -> int:
    """Bytes of B1's scratch (zeroed by the kernel's entry point): the
    ticket, then an aggregate and an inclusive slot a tile."""
    tiles = B * max(1, -(-N // _TILE))
    return 16 + 2 * tiles * _SLOT_BYTES


def encode_bits_fused(desc: torch.Tensor, tbl: torch.Tensor,
                      base_bits: torch.Tensor, num_words: int):
    """Lookup + offsets + deposit over a (B, N) desc stream: the wrapper of
    kernel B1.

    tbl: (B, 8, 128) int32 from pack_table; base_bits: (B,) int32 start
    offsets (serialized prefix bits, below 2^16).  Returns (words
    (B, num_words) int32 uint32 patterns, total_bits (B,) int64, last_tok
    (B,) int64, as the bit offsets themselves).  Every word equals
    encode_bits_plain's; num_words is below 2^30 (B2's limit).  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel (one
    launch, counted in `encode_bits_fused.launches`, after a memset of its
    scratch) or raises.
    """
    if desc.device.type == "cpu":
        return encode_bits_plain(desc, tbl, base_bits, num_words)
    B, N = desc.shape
    tbl = tbl.reshape(B, 1024)
    K.require_cuda("encode_bits_fused", desc, tbl, base_bits)
    if base_bits.shape != (B,):
        raise ValueError("encode_bits_fused: base_bits must be (B,)")
    if N >= 1 << 31 or num_words >= 1 << 30:
        raise ValueError("encode_bits_fused: units or words past 2^31, "
                         "2^30")
    dev = desc.device
    # the kernel writes every word, total_bits and last_tok
    words = torch.empty((B, num_words), dtype=torch.int32, device=dev)
    total = torch.empty(B, dtype=torch.int64, device=dev)
    last_tok = torch.empty_like(total)
    scratch = torch.empty(_scratch_bytes(B, N), dtype=torch.uint8,
                          device=dev)
    K.check(K.lib().fpng_encfuse(
        desc.data_ptr(), tbl.data_ptr(), base_bits.data_ptr(), B, N,
        num_words, words.data_ptr(), total.data_ptr(), last_tok.data_ptr(),
        scratch.data_ptr(), K.stream_ptr(dev)), "fpng_encfuse")
    encode_bits_fused.launches += 1
    return words, total, last_tok


encode_bits_fused.launches = 0


def demote_mask_plain(deltas: torch.Tensor, len_sym: torch.Tensor,
                      len_extra: torch.Tensor, cand: torch.Tensor,
                      tbl: torch.Tensor) -> torch.Tensor:
    """Plain torch version of kernel B7 (same contract as demote_mask):
    fpng_tpu's XLA formula (fpng_tpu/models/encoder.py:111-115) on the
    code sizes packed in tbl."""
    B, H, W, Cc = deltas.shape
    sizes = tbl.reshape(B, -1).to(torch.int64) >> 16
    lit_sz = torch.gather(sizes, 1, deltas.reshape(B, -1).to(torch.int64))
    # len_sym is read only where cand is set
    sym = torch.where(cand, len_sym, 0).reshape(B, -1).to(torch.int64)
    msz = torch.gather(sizes, 1, sym).reshape(B, H, W)
    return cand & (msz + len_extra + 1 >
                   lit_sz.reshape(B, H, W, Cc).sum(dim=-1))


def demote_mask(deltas: torch.Tensor, len_sym: torch.Tensor,
                len_extra: torch.Tensor, cand: torch.Tensor,
                tbl: torch.Tensor) -> torch.Tensor:
    """The 32 bpp 1-pass cost check (fpng.cpp:1520-1528): the wrapper of
    kernel B7 (csrc/demote.cu), which replaces fpng_tpu's demote_mask_tpu.

    deltas (B, H, W, 4) uint8 filtered pixels; len_sym/len_extra (B, H, W)
    int32 length symbol and extra-bit count of each match start; cand
    (B, H, W) bool, the 1-pixel match starts; tbl (B, 8, 128) int32 from
    pack_table.  Returns (B, H, W) bool: the candidates whose match costs
    strictly more bits (size(len_sym) + extra + 1 distance bit) than their
    four literals.  A CPU tensor takes demote_mask_plain; a CUDA tensor
    launches the kernel (counted in `demote_mask.launches`) or raises.
    """
    if deltas.device.type == "cpu":
        return demote_mask_plain(deltas, len_sym, len_extra, cand, tbl)
    B, H, W, Cc = deltas.shape
    K.require_cuda("demote_mask", len_sym, len_extra, tbl)
    dev = len_sym.device
    for t, dt in ((deltas, torch.uint8), (cand, torch.bool)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError("demote_mask: deltas must be contiguous uint8 "
                             "and cand contiguous bool, on the same device")
    if Cc != 4 or tbl.shape != (B, 8, 128) or \
            any(t.shape != (B, H, W) for t in (len_sym, len_extra, cand)):
        raise ValueError("demote_mask: deltas (B, H, W, 4), len_sym, "
                         "len_extra and cand (B, H, W), tbl (B, 8, 128)")
    if H * W >= 1 << 31 or deltas.data_ptr() % 4:
        raise ValueError("demote_mask: more pixels than int32 indexes, or "
                         "deltas not aligned to 4 bytes")
    out = torch.empty((B, H, W), dtype=torch.bool, device=dev)
    K.check(K.lib().fpng_demote(
        deltas.data_ptr(), len_sym.data_ptr(), len_extra.data_ptr(),
        cand.data_ptr(), tbl.data_ptr(), B, H * W, out.data_ptr(),
        K.stream_ptr(dev)), "fpng_demote")
    demote_mask.launches += 1
    return out


demote_mask.launches = 0
