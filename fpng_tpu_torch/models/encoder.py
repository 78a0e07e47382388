"""Batched encoder pipeline (counterpart of fpng_tpu/models/encoder.py).

One pass over a same-shape (B, H, W, C) batch on one device:

    filter -> RLE match resolution (row scans) -> per-unit descriptors ->
    kernel B1 (code lookup, bit offsets, word deposit) -> adler32 ->
    kernel B2 (IDAT CRC from the words) -> host memcpy splice

Host work is O(1) per image: container framing and the stored-block
fallback decision (fpng.cpp:1662-1829).  Outputs are byte-identical to
fpng_tpu.encode_batch under the same tables.

Every mode is ported: 1-pass and 2-pass (FPNG_ENCODE_SLOWER), at 24 and
32 bpp, with the device IDAT CRC, and FPNG_FORCE_UNCOMPRESSED.  32 bpp
1-pass runs fpng's cost check (kernel B7, ops/encfuse.demote_mask) in the
prologue.  2-pass first histograms the tokens on the device (hist_kernel),
builds each image's tables on the host (the native runtime, else its
Python twin) and then encodes with them.  encode_batch_stream pipelines
batches over the same stages, with pinned host buffers (transfer.py).

Spans (utils/trace.py): a call - encode_batch, or a batch of
encode_batch_stream - is traced while a torch.profiler session is enabled;
untraced, a span reads one flag.  A traced call opens a profiler range and
a registry entry for each stage: `encoder.upload` (pixels and table
columns to the device), `.tables`, `.kernel` (the prologue and B1; for
2-pass also the histogram), `.crc` (B2's host prologue and launch),
`.readback`, `.container` (the host splice) and `.stored` (the
stored-block fallback and FPNG_FORCE_UNCOMPRESSED).  No span synchronises.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as C

from ..ops.assemble import idat_crc_words, raw_idat_prefix
from ..ops.checksum import adler32_bytes
from ..ops.encfuse import (DESC_EXTRA_N_SHIFT, DESC_EXTRA_VAL_SHIFT,
                           DESC_TOK_START, DESC_USE_TABLE, _MAX_BASE_BITS,
                           demote_mask, encode_bits_fused, pack_table)
from ..ops.filter import filter_deltas
from ..ops.tokenize import match_fields
from ..tables import one_pass_state
from ..utils import trace
from .transfer import finish_readback, start_readback, to_device


def _len_sym_extra(adj: torch.Tensor):
    """Deflate length symbol + extra-bit count from adj = length - 3
    (RFC 1951 3.2.5: symbol groups of 4 double their extra bits)."""
    l = adj  # 0..255
    hb = sum((l >= t).to(torch.int32) for t in (2, 4, 8, 16, 32, 64, 128))
    e = torch.clamp(hb - 2, min=0)
    base_l = 1 << torch.clamp(e + 2, min=3)  # 8 << (e-1), e >= 1
    sym = torch.where(e == 0, 257 + l, 261 + 4 * e + ((l - base_l) >> e))
    sym = torch.where(l == 255, 285, sym)  # length 258: own symbol
    e = torch.where(l == 255, 0, e)
    return sym, e


def _sym_hist(syms: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-image masked histogram of syms (B, N) -> (B, 288) int64: an
    exact integer scatter-add (fpng_tpu's bf16 one-hot and its 2^24 switch
    are TPU layout)."""
    out = torch.zeros((syms.shape[0], C.NUM_LIT_SYMS), dtype=torch.int64,
                      device=syms.device)
    return out.scatter_add_(1, syms.to(torch.int64), mask.to(torch.int64))


def _budget(h: int, w: int, c: int) -> int:
    """Reference output-buffer budget for the deflate stream."""
    return ((58 + (w * c + 1) * h + 7) & ~7) - 58


def _num_words(budget: int) -> int:
    """Encode buffer size in words, rounded up to 1024 (one 4096-byte CRC
    chunk); the round-up is dead zeros."""
    return -(-max(budget // 4 + 4, 8) // 1024) * 1024


def tokens(imgs, num_chans: int):
    """Filter and RLE tokens of a (B, H, W, C) uint8 batch: (deltas, eq,
    mstart, mlen_px, adj, len_sym, len_extra), the inputs of the desc
    stream, the cost check and the 2-pass histogram."""
    Cc = imgs.shape[3]
    if Cc != num_chans:
        raise ValueError(f"images have {Cc} channels, not {num_chans}")
    deltas = filter_deltas(imgs)
    eq, mstart, mlen_px = match_fields(deltas, num_chans)
    adj = torch.where(mstart, mlen_px * Cc - 3, 0)
    len_sym, len_extra = _len_sym_extra(adj)  # (B, H, W)
    return deltas, eq, mstart, mlen_px, adj, len_sym, len_extra


def build_desc(imgs, codes, sizes, pend_val, pend_n, *, num_chans: int,
               cost_check: bool):
    """Token-assembly prologue: images -> per-unit descriptor stream.

    imgs (B, H, W, C) uint8; codes/sizes (B, 288); pend_val/pend_n (B,).
    cost_check runs fpng's 32 bpp 1-pass rule (kernel B7).  Returns (desc
    (B, N) int32, tbl (B, 8, 128) int32, deltas, lit_pixel, mstart,
    len_sym).  The stream order is [pending tail, per row: filter byte +
    W*C byte units, EOB] (fpng.cpp:1163-1265).
    """
    B, H, W, Cc = imgs.shape
    dev = imgs.device
    deltas, eq, mstart, mlen_px, adj, len_sym, len_extra = tokens(
        imgs, num_chans)
    d32 = deltas.to(torch.int32)
    tbl = pack_table(codes, sizes)
    if cost_check:
        # 32 bpp 1-pass: a 1-pixel match becomes 4 literals when that is
        # strictly cheaper (fpng.cpp:1520-1528)
        demote = demote_mask(deltas, len_sym, len_extra,
                             mstart & (mlen_px == 1), tbl)
        mstart = mstart & ~demote
        lit_pixel = ~eq | demote
    else:
        lit_pixel = ~eq

    # per-byte unit descriptors (layout in ops/encfuse.py)
    k0 = torch.zeros(Cc, dtype=torch.bool, device=dev)
    k0[0] = True
    lit_desc = d32 | DESC_USE_TABLE | \
        torch.where(k0, DESC_TOK_START, 0).to(torch.int32)
    m_desc = (len_sym | DESC_USE_TABLE | DESC_TOK_START |
              ((len_extra + 1) << DESC_EXTRA_N_SHIFT) |
              ((adj & ((1 << len_extra) - 1)) << DESC_EXTRA_VAL_SHIFT))
    unit_desc = torch.where(
        lit_pixel[..., None], lit_desc,
        torch.where(mstart[..., None] & k0, m_desc[..., None], 0))

    # filter-byte units: literal 0 for row 0, 2 for the rest (no tok flag:
    # the reference's flush rule checks at pixel-token granularity)
    fvals = torch.where(torch.arange(H, device=dev) > 0, 2, 0)
    f_desc = (fvals | DESC_USE_TABLE).to(torch.int32).expand(B, H)
    row_desc = torch.cat(
        [f_desc[:, :, None], unit_desc.reshape(B, H, W * Cc)], dim=2)
    pend_desc = ((pend_n.to(torch.int32) << DESC_EXTRA_N_SHIFT) |
                 (pend_val.to(torch.int32) << DESC_EXTRA_VAL_SHIFT))
    eob_desc = torch.full((B, 1), 256 | DESC_USE_TABLE, dtype=torch.int32,
                          device=dev)
    desc = torch.cat(
        [pend_desc[:, None], row_desc.reshape(B, -1), eob_desc], dim=1)
    return desc, tbl, deltas, lit_pixel, mstart, len_sym


def encode_kernel(imgs, codes, sizes, base_bits, pend_val, pend_n, *,
                  num_chans: int, cost_check: bool, want_hist: bool,
                  num_words: int):
    """Device encode of a (B, H, W, C) uint8 batch.

    Returns (words (B, num_words) int32, total_bits (B,) int64,
    last_token_start (B,) int64, adler (B,) int64, hist): hist is the
    (B, 288) int64 token histogram of the tokens this encode emits (the
    prologue's own literals and matches, plus the filter bytes) when
    want_hist, else a (B, 1) zero tensor.
    """
    B, H, W, Cc = imgs.shape
    desc, tbl, deltas, lit_pixel, mstart, len_sym = build_desc(
        imgs, codes, sizes, pend_val, pend_n, num_chans=num_chans,
        cost_check=cost_check)
    words, total_bits, last_tok = encode_bits_fused(
        desc, tbl, base_bits, num_words)

    # adler32 over the filtered stream (filter bytes included)
    fvals = torch.where(torch.arange(H, device=imgs.device) > 0, 2, 0)
    stream_u8 = torch.cat(
        [fvals.to(torch.uint8)[None, :, None].expand(B, H, 1),
         deltas.reshape(B, H, W * Cc)], dim=2).reshape(B, -1)
    hist = (_token_hist(deltas, lit_pixel, mstart, len_sym) if want_hist
            else torch.zeros((B, 1), dtype=torch.int64, device=imgs.device))
    return words, total_bits, last_tok, adler32_bytes(stream_u8), hist


def _token_hist(deltas, lit_pixel, mstart, len_sym) -> torch.Tensor:
    """(B, 288) int64 histogram of the literal bytes of the literal pixels,
    the match length symbols and the filter bytes (symbol 0 once for row
    0, symbol 2 for the other H - 1 rows)."""
    B, H = deltas.shape[:2]
    hist = _sym_hist(deltas.reshape(B, -1),
                     lit_pixel[..., None].expand(deltas.shape)
                     .reshape(B, -1)) + \
        _sym_hist(len_sym.reshape(B, -1), mstart.reshape(B, -1))
    hist[:, 0] += 1
    hist[:, 2] += H - 1
    return hist


def hist_kernel(imgs, *, num_chans: int) -> torch.Tensor:
    """Pass 1 of 2-pass mode: the (B, 288) int64 token histogram of each
    image, filter bytes included."""
    deltas, eq, mstart, _, _, len_sym, _ = tokens(imgs, num_chans)
    return _token_hist(deltas, ~eq, mstart, len_sym)


# ---------------------------------------------------------------------------
# Host driver
# ---------------------------------------------------------------------------


def _stored_png(img: np.ndarray) -> bytes:
    from ..container import build_png
    from ..golden import write_stored_stream

    h, w, c = img.shape
    filtered0 = np.zeros((h, 1 + w * c), np.uint8)
    filtered0[:, 1:] = img.reshape(h, w * c)
    return build_png(write_stored_stream(filtered0), w, h, c)


def _validate(images: np.ndarray):
    if images.ndim != 4:
        raise ValueError("encode_batch expects (B, H, W, C) uint8")
    B, H, W, Cc = images.shape
    if Cc not in (3, 4):
        raise ValueError("channels must be 3 or 4")
    if H < 1 or W < 1 or W * H > 0xFFFFFFFF or \
            W > C.MAX_SUPPORTED_DIM or H > C.MAX_SUPPORTED_DIM:
        raise ValueError("unsupported dimensions")


def launch_assemble(words, total_bits, adler, prefixes):
    """Issue the device IDAT CRC (ops/assemble.py: on a card, one upload
    and one launch); no sync.  Returns the (B,) int64 CRC tensor.  The rest
    of container assembly is the host memcpy in _finish_batch_devcrc."""
    plens = np.array([len(p) for p in prefixes], np.int64)
    raw_ip = raw_idat_prefix(prefixes).astype(np.int64)
    return idat_crc_words(words, total_bits, adler, plens, raw_ip)


_IEND12 = b"\x00\x00\x00\x00IEND\xaeB`\x82"


def _finish_batch_devcrc(images, words, crc, total_bits, last_tok, adler,
                         prefixes, budget) -> list[bytes]:
    """Host tail of the device-CRC assembly, on the results read back as
    numpy arrays: per-image memcpy splice of hdr58 + prefix + payload words
    + adler + crc + IEND, with the stored fallback where the budget rule
    fired (fpng.cpp:1728-1758)."""
    from ..container import build_header

    B, H, W, Cc = images.shape
    last_tok = last_tok.astype(np.int64)
    tb = (total_bits.astype(np.int64) + 7) >> 3
    plens = np.array([len(p) for p in prefixes], np.int64)
    fail = ((last_tok >= 0) & ((last_tok >> 3) + 8 > budget)) | \
        (tb + 4 > budget) | (plens > budget)
    hdr50 = build_header(0, W, H, Cc)[:50]
    wb = words.view(np.uint8)  # (B, NW*4) little-endian payload bytes
    stored = {}
    if fail.any():
        with trace.span("encoder.stored"):
            stored = {b: _stored_png(images[b]) for b in np.flatnonzero(fail)}
    out = []
    for b in range(B):
        if fail[b]:
            out.append(stored[b])
            continue
        t = int(tb[b])
        p = prefixes[b]
        out.append(b"".join((
            hdr50, (t + 4).to_bytes(4, "big"), b"IDAT", p,
            wb[b, len(p):t].tobytes(),
            int(adler[b]).to_bytes(4, "big"),
            int(crc[b]).to_bytes(4, "big"), _IEND12)))
    return out


def _build_tables_python(hist: np.ndarray, Cc: int):
    """Per-image table build + header emit (Python twin of the native
    runtime's build_tables_batch)."""
    from ..bitio import BitWriter
    from ..huffman import build_tables, emit_dynamic_block_header

    B = hist.shape[0]
    codes = np.zeros((B, C.NUM_LIT_SYMS), np.uint32)
    sizes = np.zeros((B, C.NUM_LIT_SYMS), np.int32)
    prefixes: list[bytes] = []
    pend_val = np.zeros(B, np.uint32)
    pend_n = np.zeros(B, np.int32)
    for b in range(B):
        freq = hist[b].copy()
        freq[256] = 1
        t = build_tables(freq, Cc)
        codes[b] = t.lit_codes
        sizes[b] = t.lit_sizes
        wtr = BitWriter()
        wtr.put_and_drain(C.ZLIB_HDR0, 8)
        wtr.put_and_drain(C.ZLIB_HDR1, 8)
        wtr.put_and_drain(1, 1)
        emit_dynamic_block_header(wtr, t)
        pend_val[b], pend_n[b] = wtr.pending
        wtr._acc = wtr._nacc = 0
        prefixes.append(wtr.getvalue())
    return codes, sizes, prefixes, pend_val, pend_n


def _prepare_tables(images: np.ndarray, hist_dev, flags: int, dev):
    """Per-batch table state: (codes, sizes) (B, 288) int64 tensors on dev,
    the header prefixes, pend_val and pend_n (B,) numpy, and cost_check.
    For 2-pass, hist_dev is the device histogram; reading it here is the
    stage's one device sync."""
    B, Cc = images.shape[0], images.shape[3]
    if flags & C.FPNG_ENCODE_SLOWER:
        from .. import runtime

        hist = hist_dev.cpu().numpy().astype(np.uint32)
        if runtime.available():
            codes, sizes, prefixes, pend_val, pend_n = \
                runtime.build_tables_batch(hist, Cc)
        else:
            codes, sizes, prefixes, pend_val, pend_n = \
                _build_tables_python(hist, Cc)
        codes, sizes = (to_device(a.astype(np.int64), dev)
                        for a in (codes, sizes))
        return codes, sizes, prefixes, pend_val, pend_n, False
    st = one_pass_state(Cc, dev)
    return (st.codes.expand(B, -1), st.sizes.expand(B, -1), [st.prefix] * B,
            np.full(B, st.acc), np.full(B, st.nacc), Cc == 4)


def encode_batch(images, flags: int = 0, device="cuda") -> list[bytes]:
    """Encode a (B, H, W, C) uint8 batch into PNG byte strings on
    `device`."""
    images = np.ascontiguousarray(images, dtype=np.uint8)
    return encode_batch_device_input(None, images, flags, device)


def _encode_launch(dev_imgs, images: np.ndarray, flags: int, hist):
    """Queue one batch's device encode: the tables (for 2-pass, reading
    the device histogram `hist` is the stage's one sync), the desc stream,
    kernel B1 and the IDAT CRC.  Returns the readback of (words, crc,
    total_bits, last_tok, adler), the header prefixes and the budget."""
    B, H, W, Cc = images.shape
    dev = dev_imgs.device
    budget = _budget(H, W, Cc)
    with trace.span("encoder.tables"):
        codes, sizes, prefixes, pend_val, pend_n, cost_check = \
            _prepare_tables(images, hist, flags, dev)
    # desc-field invariants (ops/encfuse.py layout), for every image: the
    # pending tail carries <= 7 bits, and the header prefix fits base_bits
    assert int(pend_n.max()) <= 7 and int(pend_val.max()) < (1 << 13)
    assert max(map(len, prefixes)) * 8 < _MAX_BASE_BITS

    with trace.span("encoder.upload"):
        base_bits, pv, pn = (
            to_device(np.asarray(a, np.int32), dev)
            for a in ([len(p) * 8 for p in prefixes], pend_val, pend_n))
    with trace.span("encoder.kernel"):
        words, total_bits, last_tok, adler, _ = encode_kernel(
            dev_imgs, codes, sizes, base_bits, pv, pn, num_chans=Cc,
            cost_check=cost_check, want_hist=False,
            num_words=_num_words(budget))
    with trace.span("encoder.crc"):
        crc = launch_assemble(words, total_bits, adler, prefixes)
    return (start_readback((words, crc, total_bits, last_tok, adler)),
            prefixes, budget)


def _encode_finish(images: np.ndarray, launched) -> list[bytes]:
    readback, prefixes, budget = launched
    with trace.span("encoder.readback"):
        results = finish_readback(readback)
    with trace.span("encoder.container"):
        return _finish_batch_devcrc(images, *results, prefixes, budget)


def _hist(dev_imgs, flags: int):
    if not flags & C.FPNG_ENCODE_SLOWER:
        return None
    with trace.span("encoder.kernel"):
        return hist_kernel(dev_imgs, num_chans=dev_imgs.shape[3])


def _stored(images: np.ndarray) -> list[bytes]:
    """FPNG_FORCE_UNCOMPRESSED: every image as stored blocks, on the host."""
    with trace.span("encoder.stored"):
        return [_stored_png(img) for img in images]


def encode_batch_device_input(dev_imgs, images: np.ndarray, flags: int = 0,
                              device="cuda") -> list[bytes]:
    """encode_batch over images already on the device (`dev_imgs`, or None
    to copy `images` to `device`).  `images` is the matching host copy,
    used for the stored-block fallback."""
    _validate(images)
    with trace.within(trace.begin("encode_batch")):
        if flags & C.FPNG_FORCE_UNCOMPRESSED:
            return _stored(images)
        if dev_imgs is None:
            with trace.span("encoder.upload"):
                dev_imgs = to_device(images, device)
        return _encode_finish(images, _encode_launch(
            dev_imgs, images, flags, _hist(dev_imgs, flags)))


def encode_batch_stream(batches, flags: int = 0, device="cuda"):
    """Pipelined multi-batch encode on `device`: yields one list[bytes] per
    input batch, in order, each byte-identical to encode_batch's.

    Batch k+1 is staged (its pixels go up as a non-blocking copy from
    pinned memory and, for 2-pass, its histogram is queued) and launched
    before batch k's results are waited for.  Batch k's results come back
    on a side stream (transfer.py), so its host tail - the container
    splice, or the stored fallback - overlaps batch k+1's device work.
    FPNG_FORCE_UNCOMPRESSED stays on the host.  On a CPU device the stages
    run in order.
    """
    def launch(batch):
        images = np.ascontiguousarray(batch, dtype=np.uint8)
        _validate(images)
        call = trace.begin("encode_batch_stream")
        with trace.within(call):
            if flags & C.FPNG_FORCE_UNCOMPRESSED:  # stored path: host only
                return call, images, None
            with trace.span("encoder.upload"):
                dev_imgs = to_device(images, device)
            return call, images, _encode_launch(
                dev_imgs, images, flags, _hist(dev_imgs, flags))

    def finish(launched):
        call, images, state = launched
        with trace.within(call):
            if state is None:
                return _stored(images)
            return _encode_finish(images, state)

    pending = None
    for batch in batches:
        launched = launch(batch)
        if pending is not None:
            yield finish(pending)
        pending = launched
    if pending is not None:
        yield finish(pending)
