"""The plain reference: a PNG reader and writer in NumPy and zlib.

It imports nothing of the program.  `read` walks a file's chunks, checks
every chunk's CRC, the IHDR fields, the zlib stream (zlib checks its
Adler-32) and its length, and undoes the five PNG row filters; it returns
the raster or raises BadPNG.  `write` is a plain encoder (filter Up below
the first row, zlib), used by the control.

A frozen copy of `chip_smoke.py:zlib_check`'s idea (IDAT CRC, inflate,
Up defilter), widened to any chunk layout and any row filter.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {2: 3, 6: 4}  # colour type -> channels (8-bit RGB, RGBA)


class BadPNG(ValueError):
    """A file that is not a valid 8-bit RGB or RGBA PNG."""


def chunks(png: bytes):
    """[(type, data)] of a PNG, every CRC checked."""
    if png[:8] != SIGNATURE:
        raise BadPNG("signature")
    out, pos = [], 8
    while pos < len(png):
        if pos + 12 > len(png):
            raise BadPNG("truncated chunk")
        (n,) = struct.unpack(">I", png[pos:pos + 4])
        end = pos + 12 + n
        if end > len(png):
            raise BadPNG("truncated chunk")
        kind, data = png[pos + 4:pos + 8], png[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", png[end - 4:end])
        if zlib.crc32(kind + data) != crc:
            raise BadPNG(f"CRC of {kind!r}")
        out.append((kind, data))
        pos = end
        if kind == b"IEND":
            break
    if not out or out[-1][0] != b"IEND" or pos != len(png):
        raise BadPNG("no IEND at the end")
    return out


def _defilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """(H, 1 + W*C) filtered rows -> (H, W*C) raster (PNG spec 9.2)."""
    H = rows.shape[0]
    ftype, data = rows[:, 0], rows[:, 1:]
    out = np.empty_like(data)
    prev = np.zeros(data.shape[1], np.uint8)
    i = 0
    while i < H:
        f = ftype[i]
        if f in (0, 2):
            # a run of None / Up rows: Up is a running sum down a column
            j = i
            while j < H and ftype[j] == f:
                j += 1
            if f == 0:
                out[i:j] = data[i:j]
            else:
                # uint8 sums wrap mod 256, as the filter's arithmetic does
                out[i:j] = data[i:j].cumsum(axis=0, dtype=np.uint8) + prev
            prev = out[j - 1]
            i = j
            continue
        cur = data[i].astype(np.int32)
        up = prev.astype(np.int32)
        rec = np.zeros_like(cur)
        for x in range(cur.size):
            a = rec[x - bpp] if x >= bpp else 0
            c = up[x - bpp] if x >= bpp else 0
            if f == 1:
                pred = a
            elif f == 3:
                pred = (a + up[x]) >> 1
            elif f == 4:
                p = a + up[x] - c
                pa, pb, pc = abs(p - a), abs(p - up[x]), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (
                    up[x] if pb <= pc else c)
            else:
                raise BadPNG(f"row filter {f}")
            rec[x] = (cur[x] + pred) & 0xFF
        out[i] = rec.astype(np.uint8)
        prev = out[i]
        i += 1
    return out


def read(png: bytes) -> np.ndarray:
    """The (H, W, C) uint8 raster of an 8-bit RGB or RGBA PNG."""
    cs = chunks(png)
    if cs[0][0] != b"IHDR" or len(cs[0][1]) != 13:
        raise BadPNG("IHDR")
    w, h, depth, ctype, comp, filt, inter = struct.unpack(">IIBBBBB",
                                                          cs[0][1])
    if depth != 8 or ctype not in _CHANNELS or comp or filt or inter:
        raise BadPNG("IHDR fields")
    c = _CHANNELS[ctype]
    idat = b"".join(d for k, d in cs if k == b"IDAT")
    try:
        raw = zlib.decompress(idat)
    except zlib.error as e:
        raise BadPNG(f"zlib: {e}") from None
    if len(raw) != h * (1 + w * c):
        raise BadPNG("inflated length")
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + w * c)
    return _defilter(rows, c).reshape(h, w, c)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def write(img: np.ndarray) -> bytes:
    """A plain PNG of an (H, W, C) uint8 raster, C = 3 or 4."""
    h, w, c = img.shape
    flat = img.reshape(h, w * c)
    rows = np.empty((h, 1 + w * c), np.uint8)
    rows[:, 0] = 2
    rows[0, 0] = 0
    rows[0, 1:] = flat[0]
    rows[1:, 1:] = flat[1:] - flat[:-1]  # wraps mod 256
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
            + _chunk(b"IEND", b""))


def is_stored(png: bytes) -> bool:
    """Whether the first deflate block of the file's IDAT is stored (the
    block that fpng's stored fallback writes; such files are decoded by
    the host, never by the card)."""
    idat = b"".join(d for k, d in chunks(png) if k == b"IDAT")
    return (idat[2] & 6) == 0


def idat_bytes(png: bytes) -> int:
    """Bytes of the file's zlib stream."""
    return sum(len(d) for k, d in chunks(png) if k == b"IDAT")


def convert(img: np.ndarray, channels: int) -> np.ndarray:
    """A raster with `channels` channels, as a decoder asked for that many
    returns it: alpha dropped, or an opaque alpha added."""
    c = img.shape[2]
    if c == channels:
        return img
    if channels == 3:
        return img[..., :3]
    alpha = np.full(img.shape[:2] + (1,), 255, np.uint8)
    return np.concatenate([img, alpha], axis=2)
