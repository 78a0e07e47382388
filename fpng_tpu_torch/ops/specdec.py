"""Chunked speculative Huffman decode (counterpart of fpng_tpu/ops/specdec.py).

The reference decodes the single deflate block with a sequential 12-bit
table loop (fpng.cpp:2209-2901).  Here the bitstream is split into S-bit
chunks, tokens are walked from every chunk boundary in lockstep (lanes =
batch x chunks), and the chunk entry points are iterated to a fixpoint:

  pass k:   exit[c] = walk(entry[c]) for all chunks in parallel
            entry[c+1] <- exit[c]          (entry[0] = p0 is exact)

The fixpoint is exact: entry[c] is right after at most c passes, and an
unchanged pass proves every entry equals its predecessor's true exit.  A
recording pass then re-walks the chunks with exact output offsets, checks
every structural constraint the reference enforces (filter bytes, match
alignment and caps, EOB position, stream end) and emits literal records,
which kernel B10 (ops/bitpack.deposit_bits) expands into a byte raster.

LUT entries are packed as sym | clen<<9 | nextra<<13 | run_base<<16
(pack_lut), so one lookup gives the token's full geometry.

The walk loops are Python loops of torch ops.  Running a step after every
lane has stopped changes nothing, so the loops test for live lanes (a host
sync) only every _SYNC_EVERY steps.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as C

from .bitpack import deposit_bits
from .walk8 import _block

CHUNK_BITS = 2048  # S: lockstep-walk chunk size in bits (large streams)
_SYNC_EVERY = 16   # walk steps between tests for live lanes
_NO_POS = (1 << 63) - 1  # "no position": past every bit of any stream


def plan_chunks(nb: int):
    """(chunk_bits, n_chunks, max_steps) for an nb-byte stream bucket.

    Small buckets get small chunks so the recording walk's step bound
    covers every possible token count; large buckets use CHUNK_BITS with
    a 768-step cap - streams averaging under ~2.7 bits/token overflow to
    the host decoder.
    """
    bits = nb * 8
    s = 128
    while s < CHUNK_BITS and s * 256 < bits:
        s *= 2
    nc = max(1, -(-bits // s))
    st = s + 24 if s <= 744 else 768
    return s, nc, st


def pack_lut(lut: np.ndarray) -> np.ndarray:
    """Pack run geometry into a 12-bit decode LUT (host side, numpy).

    Input entries: sym | clen<<9 (huffman.build_decoder_table).  Length
    symbols gain nextra<<13 and run_base<<16; literal symbols gain a
    speculatively packed second literal (s2<<16 | len2<<25) when the
    entry's remaining window bits fully contain another literal code
    (fpng.cpp:2080-2102).
    """
    sym = lut & 511
    clen = (lut >> 9) & 15
    out = lut.astype(np.uint32) & 0x1FFF
    is_len = (sym > 256) & (sym <= 285) & (lut != 0)
    idx = np.clip(sym - 257, 0, 28)
    nextra = np.where(is_len, C.LEN_EXTRA_BY_SYM[idx], 0).astype(np.uint32)
    base = np.where(is_len, C.LEN_BASE_BY_SYM[idx], 0).astype(np.uint32)
    out = out | (nextra << 13) | (base << 16)

    # second-symbol packing: canonical LUT entries for a code of length L
    # repeat across all indices sharing the low L bits, so indexing with
    # the zero-extended remainder is exact whenever len2 <= 12 - clen
    i12 = np.arange(lut.shape[0], dtype=np.uint32)
    rem = (i12 >> clen) & 0xFFF
    e2 = lut[rem]
    s2 = (e2 & 511).astype(np.uint32)
    l2 = ((e2 >> 9) & 15).astype(np.uint32)
    lit1 = (sym < 256) & (clen > 0)
    ok2 = lit1 & (l2 > 0) & (s2 < 256) & (l2 + clen <= 12)
    out = out | np.where(ok2, (s2 << 16) | (l2 << 25), 0).astype(np.uint32)
    # syms 286/287 are not legal deflate length codes; they keep their
    # clen (walks must keep advancing) but carry no geometry, and the
    # record pass rejects them on the true chain
    return out


def _window24(stream: torch.Tensor) -> torch.Tensor:
    """(B, Nb) uint8 -> (B, Nb) int64 of 24-bit LE windows at each byte."""
    s = torch.nn.functional.pad(stream.to(torch.int64), (0, 2))
    return s[:, :-2] | (s[:, 1:-1] << 8) | (s[:, 2:] << 16)


def _step(w24, lutp, pos):
    """Decode the token at bit positions pos: full geometry, no record.

    Returns (sym, clen, tok_bits, outlen, run, stop).  Every valid window
    advances; only clen == 0 (incomplete tables) stops a lane.  Lanes that
    have stopped may sit past the stream; their byte index is clamped and
    their results are never used.
    """
    byte = torch.clamp(pos >> 3, max=w24.shape[1] - 1)
    w = torch.gather(w24, 1, byte)
    sh = pos & 7
    e = torch.gather(lutp, 1, (w >> sh) & 0xFFF)
    sym = e & 511
    clen = (e >> 9) & 15
    nextra = (e >> 13) & 7
    base = (e >> 16) & 0x1FF
    is_match = (sym > 256) & (sym <= 285)
    run = base + ((w >> (sh + clen)) & ((1 << nextra) - 1))
    # match token = length code + extra bits + the 1-bit distance code
    tok = clen + torch.where(is_match, nextra + 1, 0)
    outlen = torch.where(sym < 256, 1, torch.where(is_match, run, 0))
    return sym, clen, tok, outlen, run, clen == 0


def _walk(w24, lutp, entries, ends, dead, max_steps):
    """Lockstep chunk walk: (exit_pos, out_bytes) per lane.

    `dead` lanes (chunk start past the true stream end) are pinned to a
    constant exit so the fixpoint converges in O(sync) passes: the zero
    padding past a stream decodes as a periodic token pattern that never
    self-synchronizes.
    """
    pos = entries
    out = torch.zeros_like(entries)
    act = (entries < ends) & ~dead
    for i in range(max_steps):
        if i % _SYNC_EVERY == 0 and not bool(act.any()):
            break
        _sym, _clen, tok, outlen, _run, stop = _step(w24, lutp, pos)
        adv = act & ~stop
        pos = torch.where(adv, pos + tok, pos)
        out = out + torch.where(adv, outlen, 0)
        act = adv & (pos < ends)
    return torch.where(dead, 0, pos), torch.where(dead, 0, out)


def record_offsets(rec_out: torch.Tensor, total: int):
    """The record expansion's geometry: (B, ST, NC) int32 output slots ->
    (B, NC * ST) int32 lane-major slot offsets, the bit shift that makes
    them bit offsets (16 bits a slot) and the deposit's word count for a
    `total`-slot raster.  The slots stay int32 (total < 2^31); their bit
    offsets pass 2^31 once the raster passes 2^27 bytes, and B10 widens
    them to 64 bits."""
    B = rec_out.shape[0]
    ro = rec_out.transpose(1, 2).reshape(B, -1).contiguous()
    return ro, 4, -(-(16 * (total + 1)) // 32) + 1


def chunked_bytes(B: int, nb: int, h: int, w: int, c: int) -> int:
    """Device bytes decode_kernel holds at its peak on a card for B images
    of h x w x c whose streams are packed nb bytes wide (plan_chunks(nb)
    lanes and step rows).  Its packed inputs, already on the card, are not
    counted.  Every buffer the function names lives to its return, so the
    stages add up:
      window     _window24's padded int64 copy and three int64 temporaries
      deposit    the int64 windows, the two (B, ST, NC) int32 record arrays,
                 their lane-major copies (values and offsets), the unit
                 sizes' two int32 temporaries and B10's words
      expansion  the windows, the four record arrays and B10's words, the
                 literal flags (a bool a raster byte), three int64 pixel
                 arrays (payload, last literal, fill) and three int64
                 sample arrays (deltas, their column sums, the low bytes)
    plus 48 int64 lane arrays (the walks' state and temporaries) and
    B-sized tensors, each counted at the allocator's rounding
    (ops/walk8._block).  At the 10800 x 21600 x 3 whole globe (a 512 MiB
    stream bucket: 2.1 M lanes of 768 rows) the expansion holds 54.6 GB,
    three times the globe's walk8 decode."""
    _, NC, ST = plan_chunks(nb)
    total = h * (1 + w * c)
    px = B * h * w
    w24 = _block(8 * B * nb)
    rec = _block(4 * B * ST * NC)
    dep = _block(4 * B * (-(-(16 * (total + 1)) // 32) + 1))
    window = _block(8 * B * (nb + 2)) + 3 * w24
    deposit = w24 + 6 * rec + dep
    expansion = w24 + 4 * rec + dep + _block(B * total) + \
        3 * _block(8 * px) + 3 * _block(8 * c * px)
    return max(window, deposit, expansion) + 48 * _block(8 * B * NC) + \
        16 * _block(8 * B)


def decode_kernel(stream, lutp, p0, zlib_len, *, h: int, w: int, c: int,
                  n_chunks: int, chunk_bits: int = CHUNK_BITS,
                  max_steps: int = 768):
    """Device decode of B same-shape fpng dynamic-block streams.

    stream: (B, Nb) uint8 zlib payloads (from the zlib header), zero
    padded; lutp: (B, 4096) int64 packed LUTs; p0: (B,) first token bit
    position; zlib_len: (B,) IDAT byte lengths.  chunk_bits/n_chunks/
    max_steps come from plan_chunks(Nb).
    Returns (imgs (B,h,w,c) uint8, ok (B,) bool, overflow (B,) bool).
    """
    B = stream.shape[0]
    dev = stream.device
    S = chunk_bits
    NC = n_chunks
    bpl = w * c
    row_stride = 1 + bpl
    total = h * row_stride
    if total >= 1 << 31:  # the records hold output slots as int32
        raise ValueError("the chunked decode takes rasters under 2^31 bytes")
    p0 = p0.to(torch.int64)
    zlib_len = zlib_len.to(torch.int64)

    w24 = _window24(stream)
    starts = (torch.arange(NC, dtype=torch.int64, device=dev) * S)[None, :]
    # lanes whose chunk lies entirely past the true stream end never hold
    # real-chain positions; pin them so the fixpoint ignores the padding.
    # Clamping every lane's end to the true stream end keeps walks out of
    # the zero tail.
    zl8 = zlib_len[:, None] * 8
    dead = starts >= zl8
    bounds = torch.minimum(starts + S, zl8)

    # --- entry fixpoint iteration -----------------------------------------
    e = starts.expand(B, NC).clone()
    e[:, 0] = p0
    outb = torch.zeros_like(e)
    k, changed = 0, True
    while changed and k <= NC:
        x, outb = _walk(w24, lutp, e, bounds, dead, S + 24)
        new_e = torch.cat([p0[:, None], x[:, :-1]], dim=1)
        changed = bool((new_e != e).any())
        e, k = new_e, k + 1
    entries = e
    out0 = torch.cumsum(outb, dim=1) - outb  # entry output offsets

    # --- recording walk -----------------------------------------------------
    # Each step writes one dense record row (clamped output offset + sym |
    # literal flag); unused trailing slots hold the lane's final output
    # offset, so the lane-major record stream stays sorted.
    ST = max_steps
    lane_end = torch.clamp(out0 + outb, max=total)
    rec_out = lane_end.to(torch.int32)[:, None, :].expand(B, ST, NC).clone()
    rec_sym = torch.zeros((B, ST, NC), dtype=torch.int32, device=dev)

    pos, outp = entries, out0
    act = (entries < bounds) & ~dead
    fail = torch.zeros((B, NC), dtype=torch.bool, device=dev)
    eob_seen = torch.zeros_like(fail)
    eob_end = torch.full((B, NC), _NO_POS, dtype=torch.int64, device=dev)
    bad_end = eob_end.clone()
    for i in range(ST):
        if i % _SYNC_EVERY == 0 and not bool(act.any()):
            break
        sym, clen, tok, outlen, run, stop = _step(w24, lutp, pos)
        is_match = (sym > 256) & (sym <= 285)
        rowpos = outp % row_stride
        x = rowpos - 1

        # `live` tokens are on the true chain before the EOB slot; tokens
        # past it are post-stream garbage the reference never reads
        live = act & (outp < total)
        fail |= live & ((clen == 0) | (sym > 285))
        at_filter = live & (rowpos == 0)
        fexp = torch.where(outp >= row_stride, 2, 0)
        fail |= at_filter & ((sym >= 256) | (sym != fexp))
        mok = (rowpos >= 1) & (x % c == 0) & (run % c == 0) & \
            (x + run <= bpl)
        fail |= live & is_match & ~mok
        fail |= live & (rowpos >= 1) & (x % c != 0) & (sym >= 256)
        # a live EOB (outp < total) truncates the image
        fail |= live & (sym == 256)
        # the true EOB is the FIRST token at outp == total; a non-EOB
        # token reaching the total slot first must reject
        at_total = act & (outp == total)
        at_eob = at_total & (sym == 256)
        eob_seen |= at_eob
        eob_end = torch.minimum(eob_end,
                                torch.where(at_eob, pos + clen, _NO_POS))
        bad_end = torch.minimum(
            bad_end, torch.where(at_total & (sym != 256), pos, _NO_POS))

        lit = live & (sym < 256) & (clen > 0)
        rec_out[:, i, :] = torch.clamp(outp, max=total)
        rec_sym[:, i, :] = torch.where(lit, sym | 0x100, 0)

        adv = act & ~stop
        pos = torch.where(adv, pos + tok, pos)
        outp = outp + torch.where(adv, outlen, 0)
        act = adv & (pos < bounds)
    # lanes still active at the step cap: the token count exceeded the
    # bound (sub-2.7-bit average codes); the caller decodes them on host
    overflow = act.any(dim=1)

    ok = ~fail.any(dim=1) & eob_seen.any(dim=1)
    end_bits = eob_end.min(dim=1).values
    ok &= end_bits <= bad_end.min(dim=1).values
    ok &= ((end_bits + 7) >> 3) == (zlib_len - 4)

    # --- record expansion: 16-bit slots (sym | literal << 8) -----------------
    rs = rec_sym.transpose(1, 2).reshape(B, NC * ST)  # lane-major, sorted
    ro, shift, dep_words = record_offsets(rec_out, total)
    dep = deposit_bits(rs, (rs != 0).to(torch.int32) << 4, ro, dep_words,
                       shift=shift)
    pairs = dep.view(torch.uint8).reshape(B, dep_words * 4)[:, :2 * total] \
        .reshape(B, total, 2)

    # --- byte expansion (fused defilter: a match replicates the previous
    # pixel's deltas -> per-row forward fill from the last literal pixel,
    # then a column cumsum; fpng.cpp:2290-2549) -------------------------------
    syms_px = pairs[..., 0].reshape(B, h, row_stride)[:, :, 1:] \
        .reshape(B, h, w, c)
    plit = (pairs[..., 1] > 0).reshape(B, h, row_stride)[:, :, 1:] \
        .reshape(B, h, w, c)[..., 0]
    payload = torch.zeros((B, h, w), dtype=torch.int64, device=dev)
    for k in range(c):
        payload |= syms_px[..., k].to(torch.int64) << (8 * k)
    # forward fill: each pixel takes the payload of the last literal pixel
    # at or before it (pixel 0's where none is)
    xs = torch.arange(w, dtype=torch.int64, device=dev)
    last_lit = torch.cummax(torch.where(plit, xs, -1), dim=2).values
    filled = torch.gather(payload, 2, torch.clamp(last_lit, min=0))
    deltas = torch.stack([(filled >> (8 * k)) & 0xFF for k in range(c)],
                         dim=-1)
    imgs = (torch.cumsum(deltas, dim=1) & 0xFF).to(torch.uint8)
    return imgs, ok & ~overflow, overflow
