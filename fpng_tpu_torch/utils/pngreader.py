"""General-purpose PNG reader (the pvpngreader-equivalent fallback); a copy
of fpng_tpu/utils/pngreader.py, with the port's own native runtime.

When fpng_decode_memory returns NOT_FPNG, callers fall back to a general
decoder; this is ours.  Pure Python/NumPy + zlib, supporting what the
reference's pvpngreader supports (pvpngreader.cpp:376-2252): color types
0/2/3/4/6, bit depths 1/2/4/8/16, all five filters, Adam7 interlace, PLTE
and tRNS.  It is an oracle / fallback path, not a throughput path - the
fast device decoder handles the fpng subset.

Output is 8-bit with `desired_channels` in {3, 4} (16-bit samples are
downshifted), matching how the reference harness loads sources via lodepng.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_ADAM7 = [  # (x0, y0, dx, dy) - PNG spec Adam7 pass origins/strides
    (0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
    (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2),
]

_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class PngError(Exception):
    pass


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    if pb <= pc:
        return b
    return c


def _defilter(raw: np.ndarray, h: int, w: int, bpp_bytes: int,
              bpl: int) -> np.ndarray:
    """Undo PNG filters over h rows of (1 + bpl) filtered bytes.

    Routed through the native runtime (runtime/native.cpp fp_defilter)
    when available - the scalar Sub/Average/Paeth chains are the
    corpus-loading hot path of the benchmark harness (matching the
    reference's pvpngreader.cpp:1047-1152).  The NumPy fallback
    vectorizes Sub as a modular cumsum over the fb residue lanes and
    steps Average/Paeth one fb-wide lane group at a time (O(bpl/fb)
    Python iterations per row instead of O(bpl))."""
    fb = max(bpp_bytes, 1)
    from .. import runtime

    if raw.shape[1] != bpl + 1:
        raw = np.ascontiguousarray(raw[:, :bpl + 1])
    if runtime.available():
        out = runtime.defilter(raw, fb)
        if out is None:
            raise PngError("bad filter")
        return out

    out = np.zeros((h, bpl), np.uint8)
    n_lanes = -(-bpl // fb)
    pad = n_lanes * fb - bpl
    for y in range(h):
        ft = int(raw[y, 0])
        cur = raw[y, 1:].astype(np.int32)
        prev = out[y - 1].astype(np.int32) if y else np.zeros(bpl, np.int32)
        if ft == 0:
            rec = cur
        elif ft == 1:
            # rec[x] = sum of cur over the fb-stride chain, mod 256
            g = np.pad(cur, (0, pad)).reshape(n_lanes, fb)
            rec = (np.cumsum(g, axis=0, dtype=np.int64) & 0xFF) \
                .reshape(-1)[:bpl]
        elif ft == 2:
            rec = (cur + prev) & 0xFF
        elif ft == 3:
            rec = np.zeros(n_lanes * fb, np.int32)
            cg = np.pad(cur, (0, pad)).reshape(n_lanes, fb)
            pg = np.pad(prev, (0, pad)).reshape(n_lanes, fb)
            left = np.zeros(fb, np.int32)
            for i in range(n_lanes):
                left = (cg[i] + ((left + pg[i]) >> 1)) & 0xFF
                rec[i * fb:(i + 1) * fb] = left
            rec = rec[:bpl]
        elif ft == 4:
            rec = np.zeros(n_lanes * fb, np.int32)
            cg = np.pad(cur, (0, pad)).reshape(n_lanes, fb)
            pg = np.pad(prev, (0, pad)).reshape(n_lanes, fb)
            a = np.zeros(fb, np.int32)   # left
            c = np.zeros(fb, np.int32)   # upper-left
            for i in range(n_lanes):
                b = pg[i]
                p = a + b - c
                pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
                pred = np.where((pa <= pb) & (pa <= pc), a,
                                np.where(pb <= pc, b, c))
                a = (cg[i] + pred) & 0xFF
                rec[i * fb:(i + 1) * fb] = a
                c = b
            rec = rec[:bpl]
        else:
            raise PngError(f"bad filter {ft}")
        out[y] = rec.astype(np.uint8)
    return out


def _unpack_samples(rows: np.ndarray, w: int, channels: int,
                    depth: int) -> np.ndarray:
    """(h, bpl) defiltered bytes -> (h, w, channels) samples (8-bit)."""
    h = rows.shape[0]
    if depth == 8:
        return rows[:, :w * channels].reshape(h, w, channels)
    if depth == 16:
        return rows[:, :w * channels * 2].reshape(h, w, channels, 2)[..., 0]
    # sub-byte depths: unpack bits MSB-first
    bits = np.unpackbits(rows, axis=1)
    spp = w * channels  # samples per row
    idx = np.arange(spp) * depth
    vals = np.zeros((h, spp), np.uint8)
    for k in range(depth):
        vals = (vals << 1) | bits[:, idx + k]
    return vals.reshape(h, w, channels)


def _scale_depth(v: np.ndarray, depth: int) -> np.ndarray:
    if depth >= 8:
        return v.astype(np.uint8)
    maxv = (1 << depth) - 1
    return ((v.astype(np.uint32) * 255 + maxv // 2) // maxv).astype(np.uint8)


def load_png(data: bytes, desired_channels: int = 4) -> tuple:
    """Decode any supported PNG. Returns (img (h,w,desired) uint8, w, h,
    channels_in_file).  Raises PngError on malformed input."""
    if desired_channels not in (3, 4):
        raise PngError("desired_channels must be 3 or 4")
    if len(data) < 45 or data[:8] != bytes((137, 80, 78, 71, 13, 10, 26, 10)):
        raise PngError("not a PNG")
    if struct.unpack(">I", data[8:12])[0] != 13 or data[12:16] != b"IHDR":
        raise PngError("bad IHDR")
    w, h = struct.unpack(">II", data[16:24])
    depth, ctype, comp, filt, interlace = data[24:29]
    if not w or not h or w > (1 << 24) or h > (1 << 24):
        raise PngError("bad dims")
    if comp or filt or interlace > 1:
        raise PngError("bad methods")
    if ctype not in _CHANNELS:
        raise PngError(f"bad color type {ctype}")
    allowed = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
               4: (8, 16), 6: (8, 16)}[ctype]
    if depth not in allowed:
        raise PngError(f"bad depth {depth} for color type {ctype}")

    idat = bytearray()
    plte = None
    trns = None
    ofs = 33
    while ofs + 8 <= len(data):
        clen = struct.unpack(">I", data[ofs:ofs + 4])[0]
        cty = data[ofs + 4:ofs + 8]
        if ofs + 12 + clen > len(data):
            raise PngError("truncated chunk")
        cdata = data[ofs + 8:ofs + 8 + clen]
        expect = struct.unpack(
            ">I", data[ofs + 8 + clen:ofs + 12 + clen])[0]
        if zlib.crc32(data[ofs + 4:ofs + 8 + clen]) & 0xFFFFFFFF != expect:
            raise PngError("chunk crc")
        if cty == b"IEND":
            break
        elif cty == b"IDAT":
            idat += cdata
        elif cty == b"PLTE":
            if clen % 3:
                raise PngError("bad PLTE")
            plte = np.frombuffer(cdata, np.uint8).reshape(-1, 3)
        elif cty == b"tRNS":
            trns = cdata
        elif (cty[0] & 32) == 0 and cty not in (b"IHDR",):
            raise PngError(f"unknown critical chunk {cty!r}")
        ofs += 12 + clen
    else:
        raise PngError("no IEND")
    if ctype == 3 and plte is None:
        raise PngError("palette image without PLTE")

    try:
        raw = zlib.decompress(bytes(idat))
    except zlib.error as e:
        raise PngError(f"zlib: {e}") from e

    channels = _CHANNELS[ctype]
    sample_bytes = 2 if depth == 16 else 1

    def decode_pass(buf: memoryview, pw: int, ph: int):
        bpl = (pw * channels * depth + 7) // 8
        need = ph * (1 + bpl)
        if len(buf) < need:
            raise PngError("short image data")
        rows = np.frombuffer(buf[:need], np.uint8).reshape(ph, 1 + bpl)
        bpp = max((channels * depth) // 8, 1) * (1 if depth < 8 else 1)
        bpp = max((channels * depth + 7) // 8, 1)
        rec = _defilter(rows, ph, bpl, bpp if depth >= 8 else 1, bpl)
        return _unpack_samples(rec, pw, channels, depth), need

    full = np.zeros((h, w, channels), np.uint8)
    mv = memoryview(raw)
    if interlace == 0:
        img, used = decode_pass(mv, w, h)
        full = _scale_depth(img, depth) if ctype != 3 else img
        if used != len(raw):
            raise PngError("trailing image data")
    else:
        used_total = 0
        for (x0, y0, dx, dy) in _ADAM7:
            pw = (w - x0 + dx - 1) // dx
            ph = (h - y0 + dy - 1) // dy
            if pw == 0 or ph == 0:
                continue
            img, used = decode_pass(mv[used_total:], pw, ph)
            img = _scale_depth(img, depth) if ctype != 3 else img
            full[y0::dy, x0::dx] = img
            used_total += used
        if used_total != len(raw):
            raise PngError("trailing image data")

    # -> RGBA8
    if ctype == 0:
        rgba = np.dstack([full[..., 0]] * 3 +
                         [np.full((h, w), 255, np.uint8)])
        if trns is not None and len(trns) >= 2:
            key = struct.unpack(">H", trns[:2])[0]
            key8 = _scale_depth(np.array([key & ((1 << depth) - 1)]),
                                depth)[0] if depth <= 8 else (key >> 8)
            rgba[..., 3] = np.where(full[..., 0] == key8, 0, 255)
    elif ctype == 2:
        rgba = np.dstack([full, np.full((h, w), 255, np.uint8)])
        if trns is not None and len(trns) >= 6:
            kr, kg, kb = struct.unpack(">HHH", trns[:6])
            if depth == 16:
                kr, kg, kb = kr >> 8, kg >> 8, kb >> 8
            m = (full[..., 0] == kr) & (full[..., 1] == kg) & \
                (full[..., 2] == kb)
            rgba[..., 3] = np.where(m, 0, 255)
    elif ctype == 3:
        idx = full[..., 0]
        if int(idx.max()) >= len(plte):
            raise PngError("palette index out of range")
        rgb = plte[idx]
        alpha = np.full((h, w), 255, np.uint8)
        if trns is not None:
            ta = np.frombuffer(trns, np.uint8)
            pal_a = np.full(len(plte), 255, np.uint8)
            pal_a[:len(ta)] = ta
            alpha = pal_a[idx]
        rgba = np.dstack([rgb, alpha])
    elif ctype == 4:
        g = full[..., 0]
        rgba = np.dstack([g, g, g, full[..., 1]])
    else:
        rgba = full

    if desired_channels == 3:
        return np.ascontiguousarray(rgba[..., :3]), w, h, _CHANNELS[ctype]
    return rgba, w, h, _CHANNELS[ctype]
