"""Deflate / fpng-subset format constants.

Everything here is derived from RFC 1951 (DEFLATE) and the PNG spec, plus the
handful of fpng-specific constraints cataloged in SURVEY.md (reference:
fpng.cpp:498-562, 2058-2074).  The tables are *generated*
from the spec rather than transcribed.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Public flags / error codes (parity with fpng.h:34-42, 57-77)
# ---------------------------------------------------------------------------

FPNG_ENCODE_SLOWER = 1  # per-image optimal Huffman tables (2-pass)
FPNG_FORCE_UNCOMPRESSED = 2  # stored deflate blocks only (testing)

FPNG_DECODE_SUCCESS = 0
FPNG_DECODE_NOT_FPNG = 1
FPNG_DECODE_INVALID_ARG = 2
FPNG_DECODE_FAILED_NOT_PNG = 3
FPNG_DECODE_FAILED_HEADER_CRC32 = 4
FPNG_DECODE_FAILED_INVALID_DIMENSIONS = 5
FPNG_DECODE_FAILED_DIMENSIONS_TOO_LARGE = 6
FPNG_DECODE_FAILED_CHUNK_PARSING = 7
FPNG_DECODE_FAILED_INVALID_IDAT = 8
FPNG_DECODE_FILE_OPEN_FAILED = 9
FPNG_DECODE_FILE_TOO_LARGE = 10
FPNG_DECODE_FILE_READ_FAILED = 11
FPNG_DECODE_FILE_SEEK_FAILED = 12

# ---------------------------------------------------------------------------
# Format limits (fpng.cpp:107, 2966-2971)
# ---------------------------------------------------------------------------

MAX_SUPPORTED_DIM = 1 << 24
MAX_TOTAL_PIXELS_DECODE = 1 << 30  # decoder-side pixel-count limit

FDEC_SIG = bytes((82, 36, 147, 227))
FDEC_VERSION = 0

PNG_SIG = bytes((137, 80, 78, 71, 13, 10, 26, 10))

# zlib stream header used by every fpng stream: CM=8/CINFO=7, FCHECK -> 0x01
ZLIB_HDR0 = 0x78
ZLIB_HDR1 = 0x01

# Huffman alphabet sizes / code-length limits
NUM_LIT_SYMS = 288          # literal/length alphabet (only 0..285 valid)
NUM_DIST_SYMS = 32          # distance alphabet (only 0..29 valid)
NUM_CLEN_SYMS = 19          # code-length alphabet
LIT_CODE_LIMIT = 12         # fpng caps lit/len (and dist) codes at 12 bits
CLEN_CODE_LIMIT = 7         # code-length codes capped at 7 bits
DECODER_TABLE_BITS = 12     # fast-decoder LUT width == LIT_CODE_LIMIT

# Per-channel-count RLE caps, in bytes (fpng.cpp:1052 / :1330): match lengths
# are multiples of the pixel size and the encoder never emits more than
# 255 (3ch) / 252 (4ch) bytes per match.
MATCH_CAP_BYTES = {3: 255, 4: 252}
MATCH_CAP_PIXELS = {3: 85, 4: 63}

# Deflate EOB symbol
EOB_SYM = 256


def _build_length_tables() -> tuple[np.ndarray, np.ndarray]:
    """LEN_SYM[L-3] / LEN_EXTRA[L-3] for match length L in [3, 258].

    Generated from the RFC 1951 3.2.5 length-code table: 28 ranges with
    bases {3..227} and a dedicated code 285 for length 258.
    """
    bases = [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31,
             35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227]
    extras = [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2,
              3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5]
    sym = np.zeros(256, dtype=np.int32)
    ext = np.zeros(256, dtype=np.int32)
    for i, (base, e) in enumerate(zip(bases, extras)):
        lo = base
        hi = min(base + (1 << e) - 1, 257)
        sym[lo - 3:hi - 3 + 1] = 257 + i
        ext[lo - 3:hi - 3 + 1] = e
    sym[258 - 3] = 285
    ext[258 - 3] = 0
    return sym, ext


LEN_SYM, LEN_EXTRA = _build_length_tables()

# Distance codes (RFC 1951 3.2.5): fpng only ever uses distance == num_chans.
# Distance codes 0..3 map to distances 1..4 with zero extra bits, so both
# supported distances need exactly the 1-bit distance Huffman code and
# nothing else after it.
DIST_SYM = {3: 2, 4: 3}
DIST_EXTRA_BITS = {3: 0, 4: 0}

# Order in which code-length-code lengths appear in a dynamic block header
# (RFC 1951 3.2.7).
CLEN_ORDER = np.array(
    [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15],
    dtype=np.int32,
)

# Length-symbol decode tables (inverse of LEN_SYM/LEN_EXTRA): for length
# symbol 257+i, the base match length and number of extra bits.
LEN_BASE_BY_SYM = np.zeros(32, dtype=np.int32)
LEN_EXTRA_BY_SYM = np.zeros(32, dtype=np.int32)
for _l in range(3, 259):
    _s = int(LEN_SYM[_l - 3]) - 257
    if LEN_BASE_BY_SYM[_s] == 0:
        LEN_BASE_BY_SYM[_s] = _l
    LEN_EXTRA_BY_SYM[_s] = int(LEN_EXTRA[_l - 3])
