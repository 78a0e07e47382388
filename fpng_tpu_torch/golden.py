"""Scalar golden-model codec (pure NumPy/Python).

This is the P0 oracle from SURVEY.md §7: a readable, loop-level
implementation of the fpng PNG subset that every device kernel is diffed
against.  It reproduces the reference encoder's output byte-for-byte
(given the same Huffman tables) and the reference decoder's accept/reject
semantics (reference behavior: fpng.cpp:990-1580 encode, 2209-2901 decode).

Not a performance path - the batched device pipelines live in
fpng_tpu_torch.models.{encoder,decoder}.
"""

from __future__ import annotations

import zlib

import numpy as np

from . import constants as C
from .bitio import BitReader, BitWriter, BudgetExceeded
from .huffman import (
    HuffTables,
    build_decoder_table,
    build_tables,
    emit_dynamic_block_header,
)

# ---------------------------------------------------------------------------
# Filtering
# ---------------------------------------------------------------------------


def filter_image(img: np.ndarray) -> np.ndarray:
    """PNG-filter an (h, w, c) uint8 image the fpng way.

    Row 0 gets filter 0 (None); rows 1.. get filter 2 (Up = byte delta vs
    the previous scanline).  Returns (h, 1 + w*c): filter byte + deltas.
    """
    h, w, c = img.shape
    flat = img.reshape(h, w * c)
    out = np.zeros((h, 1 + w * c), dtype=np.uint8)
    out[1:, 0] = 2
    out[0, 1:] = flat[0]
    out[1:, 1:] = flat[1:] - flat[:-1]
    return out


# ---------------------------------------------------------------------------
# Greedy RLE tokenizer (the fpng LZ parse)
# ---------------------------------------------------------------------------


def tokenize_row(row_pixels: np.ndarray) -> list[tuple]:
    """Greedy parse of one filtered scanline (w, c) into tokens.

    Tokens: ('P', pixel_bytes) literal pixel, ('M', match_len_bytes) RLE
    match vs the previous pixel (distance == c).  First pixel is always
    literal; matches are capped (255B/252B) and never cross the row.
    """
    w, c = row_pixels.shape
    cap_px = C.MATCH_CAP_PIXELS[c]
    eq = np.zeros(w, dtype=bool)
    if w > 1:
        eq[1:] = np.all(row_pixels[1:] == row_pixels[:-1], axis=1)
    toks: list[tuple] = [("P", row_pixels[0])]
    x = 1
    while x < w:
        if eq[x]:
            run = 1
            while run < cap_px and x + run < w and eq[x + run]:
                run += 1
            toks.append(("M", run * c))
            x += run
        else:
            toks.append(("P", row_pixels[x]))
            x += 1
    return toks


def tokenize_image(filtered: np.ndarray, num_chans: int) -> list[list[tuple]]:
    """Per-row token lists, each prefixed with ('F', filter_byte)."""
    h = filtered.shape[0]
    rows = []
    for y in range(h):
        px = filtered[y, 1:].reshape(-1, num_chans)
        rows.append([("F", int(filtered[y, 0]))] + tokenize_row(px))
    return rows


def histogram_tokens(rows: list[list[tuple]]) -> np.ndarray:
    """288-bin literal/length histogram of a token stream (EOB forced to 1)."""
    freq = np.zeros(C.NUM_LIT_SYMS, dtype=np.uint32)
    lits: list[int] = []
    for row in rows:
        for kind, v in row:
            if kind == "F":
                lits.append(v)
            elif kind == "P":
                lits.extend(int(b) for b in v)
            else:
                freq[C.LEN_SYM[v - 3]] += 1
    np.add.at(freq, np.asarray(lits, dtype=np.int64), 1)
    freq[C.EOB_SYM] = 1
    return freq


# ---------------------------------------------------------------------------
# Stream emission
# ---------------------------------------------------------------------------


def emit_stream(rows: list[list[tuple]], tables: HuffTables, num_chans: int,
                budget: int | None, prefix: bytes | None = None,
                prefix_pending: tuple[int, int] = (0, 0),
                cost_check: bool = False) -> bytes:
    """Emit the complete zlib deflate stream body (no adler32).

    1-pass: `prefix` holds the precomputed zlib-header+block-header bytes and
    `prefix_pending` the leftover (bits, count) that spill past the last
    prefix byte.  2-pass: prefix is None and the header is emitted here.

    Raises BudgetExceeded when the output would overflow `budget` under the
    reference's flush-window rules.
    """
    w = BitWriter(budget)
    if prefix is not None:
        if budget is not None and len(prefix) > budget:
            raise BudgetExceeded
        w.append_bytes(prefix)
        w.set_pending(*prefix_pending)
    else:
        w.put_and_drain(C.ZLIB_HDR0, 8)
        w.put_and_drain(C.ZLIB_HDR1, 8)
        w.put_and_drain(1, 1)  # BFINAL
        emit_dynamic_block_header(w, tables)

    codes, sizes = tables.lit_codes, tables.lit_sizes
    prev_pixel: np.ndarray | None = None
    for row in rows:
        for tok in row:
            kind, v = tok
            if kind == "F":
                w.put(int(codes[v]), int(sizes[v]))
            elif kind == "P":
                for b in v:
                    b = int(b)
                    w.put(int(codes[b]), int(sizes[b]))
                prev_pixel = v
            else:
                adj = v - 3
                sym = int(C.LEN_SYM[adj])
                extra = int(C.LEN_EXTRA[adj])
                if cost_check and num_chans == 4 and v == 4:
                    # Single-pixel 32bpp match: emit 4 literals instead when
                    # strictly cheaper (fpng.cpp:1520-1528).  The matched
                    # pixel equals the previous literal pixel's bytes.
                    assert prev_pixel is not None
                    match_bits = int(sizes[sym]) + extra + 1
                    lit_bits = sum(int(sizes[int(b)]) for b in prev_pixel)
                    if match_bits > lit_bits:
                        for b in prev_pixel:
                            b = int(b)
                            w.put(int(codes[b]), int(sizes[b]))
                        w.flush()
                        continue
                w.put(int(codes[sym]), int(sizes[sym]))
                w.put(adj & ((1 << extra) - 1), extra + 1)
            w.flush()
    w.put(int(codes[C.EOB_SYM]), int(sizes[C.EOB_SYM]))
    w.force_flush()
    return w.getvalue()


def write_stored_stream(filtered0: np.ndarray) -> bytes:
    """zlib stream made of stored (uncompressed) deflate blocks.

    `filtered0` is the filter-0 version of the image (every row raw).
    Mirrors write_raw_block (fpng.cpp:818-866).
    """
    data = filtered0.tobytes()
    out = bytearray([C.ZLIB_HDR0, C.ZLIB_HDR1])
    ofs = 0
    n = len(data)
    while True:
        block = min(0xFFFF, n - ofs)
        final = 1 if (ofs + block) == n else 0
        out.append(final)
        out += int(block).to_bytes(2, "little")
        out += int(block ^ 0xFFFF).to_bytes(2, "little")
        out += data[ofs:ofs + block]
        ofs += block
        if final:
            break
    out += (zlib.adler32(data) & 0xFFFFFFFF).to_bytes(4, "big")
    return bytes(out)


# ---------------------------------------------------------------------------
# Encode driver
# ---------------------------------------------------------------------------


def encode_zlib(img: np.ndarray, flags: int = 0,
                one_pass_tables=None) -> bytes:
    """Produce the full zlib stream (deflate + adler32) for an image.

    `one_pass_tables`: (prefix_bytes, pending_bits, pending_count, codes,
    sizes) artifact for the default 1-pass mode; required unless
    FPNG_ENCODE_SLOWER or FPNG_FORCE_UNCOMPRESSED is set.
    """
    h, w, c = img.shape
    bpl = w * c
    filtered = filter_image(img)
    # Output budget identical to the reference driver (fpng.cpp:1701-1705).
    out_buf_size = (58 + (bpl + 1) * h + 7) & ~7
    budget = out_buf_size - 58

    if not (flags & C.FPNG_FORCE_UNCOMPRESSED):
        rows = tokenize_image(filtered, c)
        try:
            if flags & C.FPNG_ENCODE_SLOWER:
                tables = build_tables(histogram_tokens(rows), c)
                body = emit_stream(rows, tables, c, budget)
            else:
                prefix, pend_bits, pend_n, codes, sizes = one_pass_tables
                tables = HuffTables(sizes, codes, None, None)
                body = emit_stream(rows, tables, c, budget,
                                   prefix=prefix,
                                   prefix_pending=(pend_bits, pend_n),
                                   cost_check=(c == 4))
            adler = zlib.adler32(filtered.tobytes()) & 0xFFFFFFFF
            if len(body) + 4 > budget:
                raise BudgetExceeded
            return body + adler.to_bytes(4, "big")
        except BudgetExceeded:
            pass  # fall through to stored blocks

    # Stored fallback: refilter everything with filter 0.
    filtered0 = np.zeros_like(filtered)
    filtered0[:, 1:] = img.reshape(h, bpl)
    return write_stored_stream(filtered0)


def encode_image_to_memory(image, w: int, h: int, num_chans: int,
                           flags: int = 0, one_pass_tables=None) -> bytes | None:
    """Full PNG bytes, or None on invalid args (API parity fpng.h:48)."""
    from .container import build_png

    if w < 1 or h < 1 or w * h > 0xFFFFFFFF:
        return None
    if w > C.MAX_SUPPORTED_DIM or h > C.MAX_SUPPORTED_DIM:
        return None
    if num_chans not in (3, 4):
        return None
    img = np.asarray(image, dtype=np.uint8).reshape(h, w, num_chans)
    if one_pass_tables is None and not (flags & (C.FPNG_ENCODE_SLOWER |
                                                 C.FPNG_FORCE_UNCOMPRESSED)):
        from .tables import get_one_pass_tables
        one_pass_tables = get_one_pass_tables(num_chans)
    z = encode_zlib(img, flags, one_pass_tables)
    return build_png(z, w, h, num_chans)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _parse_dynamic_header(r: BitReader, num_chans: int):
    """Parse + validate the dynamic block header; return the 12-bit LUT.

    Implements the fpng-subset constraints (fpng.cpp:1954-2105): all code
    sizes <= 12; 1-2 one-bit distance codes with the distance==num_chans
    code present (and first when there are two).
    Returns np.uint32[4096] or None.
    """
    num_lit = r.get(5) + 257
    num_dist = r.get(5) + 1
    total = num_lit + num_dist
    if total > C.NUM_LIT_SYMS + C.NUM_DIST_SYMS:
        return None
    num_clen = r.get(4) + 4
    clen_sizes = np.zeros(C.NUM_CLEN_SYMS, dtype=np.uint8)
    for i in range(num_clen):
        clen_sizes[C.CLEN_ORDER[i]] = r.get(3)
    clen_table = build_decoder_table(C.NUM_CLEN_SYMS, clen_sizes)
    if clen_table is None:
        return None

    code_sizes = np.zeros(C.NUM_LIT_SYMS + C.NUM_DIST_SYMS, dtype=np.uint8)
    cur = 0
    while cur < total:
        e = clen_table[r.peek(12)]
        sym_len = (int(e) >> 9) & 15
        if not sym_len:
            return None
        r.skip(sym_len)
        sym = int(e) & 511
        if sym <= 15:
            if sym > C.DECODER_TABLE_BITS:
                return None  # fpng never emits codes > 12 bits
            code_sizes[cur] = sym
            cur += 1
            continue
        if sym == 16:
            if cur == 0:
                return None
            rep = r.get(2) + 3
            val = int(code_sizes[cur - 1])
        elif sym == 17:
            rep = r.get(3) + 3
            val = 0
        else:
            rep = r.get(7) + 11
            val = 0
        if cur + rep > total:
            return None
        code_sizes[cur:cur + rep] = val
        cur += rep

    dist_sizes = code_sizes[num_lit:num_lit + num_dist]
    valid = int((dist_sizes == 1).sum())
    if valid < 1 or valid > 2:
        return None
    if num_chans - 1 >= num_dist or code_sizes[num_lit + num_chans - 1] != 1:
        return None
    if valid == 2 and code_sizes[num_lit + num_chans] != 1:
        return None

    lit_sizes = np.zeros(C.NUM_LIT_SYMS, dtype=np.uint8)
    lit_sizes[:num_lit] = code_sizes[:num_lit]
    return build_decoder_table(num_lit, lit_sizes)


def decode_zlib(src: bytes, zlib_len: int, w: int, h: int,
                num_chans: int) -> np.ndarray | None:
    """Decode one fpng-subset zlib stream into (h, w, num_chans) uint8.

    `src` may extend past the stream (read-ahead parity); `zlib_len` is the
    IDAT length.  Returns None on any constraint violation (=> NOT_FPNG).
    """
    if zlib_len < 7 or len(src) < 3:
        return None
    if src[0] != C.ZLIB_HDR0 or src[1] != C.ZLIB_HDR1:
        return None
    if (src[2] & 6) == 0:
        return decode_stored(src, zlib_len, w, h, num_chans)

    r = BitReader(src)
    r.skip(16)
    bfinal = r.get(1)
    btype = r.get(2)
    if bfinal != 1 or btype != 2:
        return None
    lut = _parse_dynamic_header(r, num_chans)
    if lut is None:
        return None

    bpl = w * num_chans
    deltas = np.zeros((h, bpl), dtype=np.uint8)
    for y in range(h):
        e = int(lut[r.peek(12)])
        flen = (e >> 9) & 15
        if not flen:
            return None
        r.skip(flen)
        if (e & 511) != (2 if y else 0):
            return None
        row = deltas[y]
        x = 0
        while x < bpl:
            e = int(lut[r.peek(12)])
            slen = (e >> 9) & 15
            if not slen:
                return None
            r.skip(slen)
            sym = e & 511
            if sym >= 256:
                if sym == 256:  # EOB mid-scanline
                    return None
                if sym > 285:  # reserved length codes (RFC 1951 3.2.5)
                    return None
                run = int(C.LEN_BASE_BY_SYM[sym - 257])
                nx = int(C.LEN_EXTRA_BY_SYM[sym - 257])
                if nx:
                    run += r.get(nx)
                r.skip(1)  # 1-bit distance code
                if run % num_chans or run == 0:
                    return None
                if x + run > bpl:
                    return None
                # RLE vs previous pixel within the delta row.  A match at
                # x==0 replicates an implicit all-zero previous delta (the
                # reference initializes prev_delta to 0 per row and accepts
                # this, fpng.cpp:2269,2340).
                prev = row[x - num_chans:x] if x >= num_chans else \
                    np.zeros(num_chans, dtype=np.uint8)
                row[x:x + run] = np.tile(prev, run // num_chans)
                x += run
            else:
                row[x] = sym
                x += 1
                for _ in range(num_chans - 1):
                    e = int(lut[r.peek(12)])
                    slen = (e >> 9) & 15
                    if not slen:
                        return None
                    r.skip(slen)
                    sym = e & 511
                    if sym >= 256:
                        return None
                    row[x] = sym
                    x += 1
        if r.overran(len(src)):
            return None

    e = int(lut[r.peek(12)])
    slen = (e >> 9) & 15
    if not slen or (e & 511) != 256:
        return None
    r.skip(slen)
    r.align_to_byte()
    if r.consumed_bytes() != zlib_len - 4:
        return None
    # Defilter: every row adds the previous raw row (mod 256).
    raw = np.cumsum(deltas.astype(np.int64), axis=0).astype(np.uint8)
    return raw.reshape(h, w, num_chans)


def decode_stored(src: bytes, zlib_len: int, w: int, h: int,
                  num_chans: int) -> np.ndarray | None:
    """Stored-block path with filter-0 enforcement (fpng.cpp:2107-2207).

    Block framing is parsed per block (<= ceil(bytes/65535) iterations);
    the payload itself is validated and de-framed with numpy slicing -
    no per-byte Python work.
    """
    bpl = w * num_chans
    ofs = 2
    parts: list[np.ndarray] = []
    total = 0
    while True:
        if ofs + 5 > len(src):
            return None
        bfinal = src[ofs] & 1
        if (src[ofs] >> 1) & 3:
            return None
        blen = src[ofs + 1] | (src[ofs + 2] << 8)
        nlen = src[ofs + 3] | (src[ofs + 4] << 8)
        if blen != (~nlen & 0xFFFF):
            return None
        ofs += 5
        if ofs + blen > len(src):
            return None
        parts.append(np.frombuffer(src, np.uint8, blen, ofs))
        total += blen
        ofs += blen
        if bfinal:
            break
    if ofs + 4 != zlib_len:
        return None
    # raster structure: exactly h rows of (filter byte == 0) + bpl bytes
    if total != h * (bpl + 1):
        return None
    payload = np.concatenate(parts) if len(parts) > 1 else parts[0]
    rows = payload.reshape(h, bpl + 1)
    if rows[:, 0].any():
        return None
    return np.ascontiguousarray(rows[:, 1:]).reshape(h, w, num_chans)


def convert_channels(img: np.ndarray, desired: int) -> np.ndarray:
    """3<->4 channel conversion with the alpha=0xFF fill rule."""
    h, w, c = img.shape
    if c == desired:
        return img
    if desired == 4:
        out = np.empty((h, w, 4), dtype=np.uint8)
        out[..., :3] = img
        out[..., 3] = 0xFF
        return out
    return np.ascontiguousarray(img[..., :3])


def decode_memory(data: bytes, desired_channels: int = 4):
    """(status, image|None, w, h, channels_in_file) - fpng.h:108 parity."""
    from .container import get_info_internal

    if not data or desired_channels not in (3, 4):
        return C.FPNG_DECODE_INVALID_ARG, None, 0, 0, 0
    import os
    check_crcs = not os.environ.get("FPNG_TPU_DISABLE_DECODE_CRC32_CHECKS")
    status, w, h, ch, idat_ofs, idat_len = get_info_internal(
        data, check_crcs)
    if status != C.FPNG_DECODE_SUCCESS:
        return status, None, w, h, ch
    if w * h * desired_channels > 0xFFFFFFFF:
        return C.FPNG_DECODE_FAILED_DIMENSIONS_TOO_LARGE, None, w, h, ch
    src = data[idat_ofs + 8:]
    img = decode_zlib(src, idat_len, w, h, ch)
    if img is None:
        return C.FPNG_DECODE_NOT_FPNG, None, w, h, ch
    return C.FPNG_DECODE_SUCCESS, convert_channels(img, desired_channels), w, h, ch
