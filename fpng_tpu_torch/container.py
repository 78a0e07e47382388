"""PNG container assembly / parsing (host side).

The container layer is O(1) per image: the 58-byte header (PNG signature,
IHDR, the fdEC marker chunk, the IDAT chunk prefix), the IDAT CRC splice and
IEND, plus the decoder's chunk walk with fdEC gating (reference behavior:
fpng.cpp:1766-1800 and 2930-3077).

A C implementation of the hot pieces lives in fpng_tpu_torch.runtime; this module
is the always-available pure-Python fallback and the semantics reference.
"""

from __future__ import annotations

import struct
import zlib

from . import constants as C

_FDEC_CHUNK = (
    struct.pack(">I", 5) + b"fdEC" + C.FDEC_SIG + bytes([C.FDEC_VERSION])
)
_FDEC_CHUNK += struct.pack(">I", zlib.crc32(_FDEC_CHUNK[4:]))

_IEND = struct.pack(">I", 0) + b"IEND"
_IEND += struct.pack(">I", zlib.crc32(_IEND[4:]))

PNG_HEADER_SIZE = 58  # sig + IHDR + fdEC + IDAT len/type


def crc32(data: bytes, prev: int = 0) -> int:
    return zlib.crc32(data, prev) & 0xFFFFFFFF


def adler32(data: bytes, prev: int = 1) -> int:
    return zlib.adler32(data, prev) & 0xFFFFFFFF


def build_header(zlib_size: int, w: int, h: int, num_chans: int) -> bytes:
    """The fixed-size PNG prefix ending right before the zlib stream."""
    color_type = 2 if num_chans == 3 else 6
    ihdr_data = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    ihdr = struct.pack(">I", 13) + b"IHDR" + ihdr_data
    ihdr += struct.pack(">I", zlib.crc32(ihdr[4:]))
    idat_prefix = struct.pack(">I", zlib_size) + b"IDAT"
    hdr = C.PNG_SIG + ihdr + _FDEC_CHUNK + idat_prefix
    assert len(hdr) == PNG_HEADER_SIZE
    return hdr


def build_png(zlib_stream: bytes, w: int, h: int, num_chans: int) -> bytes:
    """Assemble a complete fpng-format PNG around one zlib stream."""
    hdr = build_header(len(zlib_stream), w, h, num_chans)
    idat_crc = zlib.crc32(zlib_stream, zlib.crc32(b"IDAT"))
    return hdr + zlib_stream + struct.pack(">I", idat_crc & 0xFFFFFFFF) + _IEND


def get_info_internal(data: bytes, check_crcs: bool = True):
    """Chunk walk + fdEC gate.

    Returns (status, width, height, channels_in_file, idat_ofs, idat_len)
    where idat_ofs points at the IDAT chunk's length field.  Mirrors
    fpng_get_info_internal including which CRCs are checked (all chunks
    except IDAT).
    """
    F = C
    min_size = 8 + 25 + 12 + 1 + 12  # sig + IHDR + chunk prefix+1+crc + IEND
    if len(data) < min_size:
        return F.FPNG_DECODE_FAILED_NOT_PNG, 0, 0, 0, 0, 0
    if data[:8] != C.PNG_SIG:
        return F.FPNG_DECODE_FAILED_NOT_PNG, 0, 0, 0, 0, 0

    ihdr_len = struct.unpack(">I", data[8:12])[0]
    if ihdr_len != 13:
        return F.FPNG_DECODE_FAILED_NOT_PNG, 0, 0, 0, 0, 0
    if check_crcs:
        expect = struct.unpack(">I", data[29:33])[0]
        if zlib.crc32(data[12:29]) & 0xFFFFFFFF != expect:
            return F.FPNG_DECODE_FAILED_HEADER_CRC32, 0, 0, 0, 0, 0
    w, h = struct.unpack(">II", data[16:24])
    bitdepth, color_type, comp, filt, interlace = data[24:29]

    if not w or not h or w > C.MAX_SUPPORTED_DIM or h > C.MAX_SUPPORTED_DIM:
        return F.FPNG_DECODE_FAILED_INVALID_DIMENSIONS, 0, 0, 0, 0, 0
    if w * h > C.MAX_TOTAL_PIXELS_DECODE:
        return F.FPNG_DECODE_FAILED_INVALID_DIMENSIONS, 0, 0, 0, 0, 0
    if comp or filt or interlace or bitdepth != 8:
        return F.FPNG_DECODE_NOT_FPNG, w, h, 0, 0, 0
    if color_type == 2:
        ch = 3
    elif color_type == 6:
        ch = 4
    else:
        return F.FPNG_DECODE_NOT_FPNG, w, h, 0, 0, 0

    ofs = 33
    found_fdec = False
    idat_ofs = idat_len = 0
    while True:
        if ofs >= len(data) or len(data) - ofs < 12:
            return F.FPNG_DECODE_FAILED_CHUNK_PARSING, w, h, ch, 0, 0
        chunk_len = struct.unpack(">I", data[ofs:ofs + 4])[0]
        if ofs + 12 + chunk_len > len(data):
            return F.FPNG_DECODE_FAILED_CHUNK_PARSING, w, h, ch, 0, 0
        ctype = data[ofs + 4:ofs + 8]
        if not all(65 <= c <= 90 or 97 <= c <= 122 for c in ctype):
            return F.FPNG_DECODE_FAILED_CHUNK_PARSING, w, h, ch, 0, 0
        is_idat = ctype == b"IDAT"
        if check_crcs and not is_idat:
            expect = struct.unpack(
                ">I", data[ofs + 8 + chunk_len:ofs + 12 + chunk_len])[0]
            actual = zlib.crc32(data[ofs + 4:ofs + 8 + chunk_len]) & 0xFFFFFFFF
            if actual != expect:
                return F.FPNG_DECODE_FAILED_HEADER_CRC32, w, h, ch, 0, 0
        cdata = data[ofs + 8:ofs + 8 + chunk_len]
        if ctype == b"IEND":
            break
        elif is_idat:
            if idat_ofs or not found_fdec:
                return F.FPNG_DECODE_NOT_FPNG, w, h, ch, 0, 0
            idat_ofs, idat_len = ofs, chunk_len
            if idat_len < 7:
                return F.FPNG_DECODE_FAILED_INVALID_IDAT, w, h, ch, 0, 0
        elif ctype == b"fdEC":
            if found_fdec or chunk_len != 5:
                return F.FPNG_DECODE_NOT_FPNG, w, h, ch, 0, 0
            if cdata[:4] != C.FDEC_SIG or cdata[4] != C.FDEC_VERSION:
                return F.FPNG_DECODE_NOT_FPNG, w, h, ch, 0, 0
            found_fdec = True
        else:
            if (ctype[0] & 32) == 0:  # unknown critical chunk
                return F.FPNG_DECODE_NOT_FPNG, w, h, ch, 0, 0
        ofs += 12 + chunk_len

    if not found_fdec or not idat_ofs:
        return F.FPNG_DECODE_NOT_FPNG, w, h, ch, 0, 0
    return F.FPNG_DECODE_SUCCESS, w, h, ch, idat_ofs, idat_len


def get_info(data: bytes):
    """(status, width, height, channels_in_file) - fpng.h:91 parity."""
    status, w, h, ch, _, _ = get_info_internal(data)
    return status, w, h, ch
