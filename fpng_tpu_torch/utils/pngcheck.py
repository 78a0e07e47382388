"""Strict structural PNG validator (pngcheck-class); a copy of
fpng_tpu/utils/pngcheck.py.

The reference claims every fpng output is pngcheck-clean
(reference README.md:2,81); wuffs/lodepng/zlib accept-tests catch most
corruption but not chunk-grammar details (ordering, duplication,
ancillary placement, trailing garbage).  This is a self-contained
validator enforcing the PNG 1.2 chunk grammar the way pngcheck does:

  * 8-byte signature; chunk framing (length <= 2^31-1, known-layout
    CRC over type+data) for EVERY chunk; no trailing bytes after IEND
  * IHDR first, exactly once, length 13, legal bit-depth/color-type
    combination, nonzero dims, compression/filter 0, interlace 0/1
  * PLTE: at most one, length % 3 == 0, 1..256 entries, before IDAT,
    forbidden for color types 0/4, required for type 3; tRNS/bKGD/hIST
    after PLTE; tRNS length/type rules
  * IDAT: at least one, all consecutive; IEND last, empty
  * single-instance ancillary chunks (cHRM gAMA iCCP sBIT sRGB bKGD
    hIST tRNS pHYs tIME) not repeated; cHRM/gAMA/iCCP/sBIT/sRGB before
    PLTE and IDAT
  * zlib: the IDAT concatenation inflates cleanly to exactly
    h * (1 + w*bpp) bytes (non-interlaced 8-bit) with valid adler32,
    and every scanline's filter byte is 0..4

Returns a list of violation strings; empty list == structurally clean.
"""

from __future__ import annotations

import struct
import zlib

_CRITICAL = {b"IHDR", b"PLTE", b"IDAT", b"IEND"}
_SINGLE = {b"IHDR", b"PLTE", b"IEND", b"cHRM", b"gAMA", b"iCCP", b"sBIT",
           b"sRGB", b"bKGD", b"hIST", b"tRNS", b"pHYs", b"tIME"}
_BEFORE_PLTE = {b"cHRM", b"gAMA", b"iCCP", b"sBIT", b"sRGB"}
_AFTER_PLTE_BEFORE_IDAT = {b"bKGD", b"hIST", b"tRNS"}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
           4: (8, 16), 6: (8, 16)}
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def check(data: bytes) -> list[str]:
    """Validate one PNG byte string; returns violations (empty = clean)."""
    errs: list[str] = []
    if len(data) < 8 or data[:8] != b"\x89PNG\r\n\x1a\n":
        return ["bad PNG signature"]

    ofs = 8
    seen: dict[bytes, int] = {}
    order: list[bytes] = []
    idat = bytearray()
    ihdr = None
    idat_done = False
    iend_seen = False
    while ofs < len(data):
        if len(data) - ofs < 12:
            errs.append(f"truncated chunk header at offset {ofs}")
            break
        (length,) = struct.unpack(">I", data[ofs:ofs + 4])
        ctype = data[ofs + 4:ofs + 8]
        if length > 0x7FFFFFFF:
            errs.append(f"{ctype!r}: length {length} exceeds 2^31-1")
            break
        if len(data) - ofs < 12 + length:
            errs.append(f"{ctype!r}: truncated data at offset {ofs}")
            break
        body = data[ofs + 8:ofs + 8 + length]
        (crc,) = struct.unpack(
            ">I", data[ofs + 8 + length:ofs + 12 + length])
        if zlib.crc32(data[ofs + 4:ofs + 8 + length]) & 0xFFFFFFFF != crc:
            errs.append(f"{ctype!r}: CRC mismatch")
        if not all(65 <= b <= 90 or 97 <= b <= 122 for b in ctype):
            errs.append(f"chunk type {ctype!r}: illegal type bytes")
        if ctype not in _CRITICAL and not (ctype[0] & 0x20):
            errs.append(f"unknown critical chunk {ctype!r}")
        seen[ctype] = seen.get(ctype, 0) + 1
        order.append(ctype)
        if iend_seen:
            errs.append(f"{ctype!r}: chunk after IEND")

        if ctype == b"IHDR":
            if len(order) != 1:
                errs.append("IHDR is not the first chunk")
            if length != 13:
                errs.append(f"IHDR length {length} != 13")
            else:
                w, h, depth, ct, comp, filt, inter = struct.unpack(
                    ">IIBBBBB", body)
                ihdr = (w, h, depth, ct, inter)
                if w == 0 or h == 0:
                    errs.append("IHDR: zero dimension")
                if w > 0x7FFFFFFF or h > 0x7FFFFFFF:
                    errs.append("IHDR: dimension exceeds 2^31-1")
                if ct not in _DEPTHS:
                    errs.append(f"IHDR: illegal color type {ct}")
                elif depth not in _DEPTHS[ct]:
                    errs.append(
                        f"IHDR: depth {depth} illegal for color type {ct}")
                if comp != 0:
                    errs.append(f"IHDR: compression {comp} != 0")
                if filt != 0:
                    errs.append(f"IHDR: filter method {filt} != 0")
                if inter not in (0, 1):
                    errs.append(f"IHDR: interlace {inter}")
        elif ctype == b"PLTE":
            if length % 3 or not 3 <= length <= 768:
                errs.append(f"PLTE: bad length {length}")
            if b"IDAT" in seen:
                errs.append("PLTE after IDAT")
            if ihdr and ihdr[3] in (0, 4):
                errs.append(f"PLTE with color type {ihdr[3]}")
        elif ctype == b"IDAT":
            if idat_done:
                errs.append("non-consecutive IDAT chunks")
            idat += body
        elif ctype == b"IEND":
            iend_seen = True
            if length:
                errs.append(f"IEND: nonempty ({length} bytes)")
        elif ctype == b"tRNS" and ihdr:
            ct = ihdr[3]
            if ct in (4, 6):
                errs.append(f"tRNS with color type {ct}")
        if ctype != b"IDAT" and idat:
            idat_done = True
        if ctype in _BEFORE_PLTE and (b"PLTE" in seen or b"IDAT" in seen):
            errs.append(f"{ctype!r} after PLTE/IDAT")
        if ctype in _AFTER_PLTE_BEFORE_IDAT and b"IDAT" in seen:
            errs.append(f"{ctype!r} after IDAT")
        ofs += 12 + length

    for t, n in seen.items():
        if t in _SINGLE and n > 1:
            errs.append(f"{t!r}: {n} instances")
    if b"IHDR" not in seen:
        errs.append("missing IHDR")
    if b"IDAT" not in seen:
        errs.append("missing IDAT")
    if not iend_seen:
        errs.append("missing IEND")
    elif order and order[-1] != b"IEND":
        errs.append("IEND is not the last chunk")
    if ofs != len(data):
        errs.append(f"{len(data) - ofs} trailing bytes after IEND")
    if ihdr and ihdr[3] == 3 and b"PLTE" not in seen:
        errs.append("color type 3 without PLTE")

    # zlib / scanline structure (non-interlaced 8/16-bit only: exact
    # expected length check; interlaced files only get inflate+adler)
    if ihdr and idat and not errs:
        w, h, depth, ct, inter = ihdr
        try:
            raw = zlib.decompress(bytes(idat))
        except zlib.error as e:
            errs.append(f"IDAT: zlib error: {e}")
            return errs
        if not inter and depth >= 8:
            bpl = 1 + (w * _CHANNELS[ct] * depth) // 8
            if len(raw) != h * bpl:
                errs.append(
                    f"IDAT: inflated {len(raw)} bytes != {h * bpl}")
            else:
                for y in range(h):
                    f = raw[y * bpl]
                    if f > 4:
                        errs.append(f"scanline {y}: filter byte {f}")
                        break
    return errs
