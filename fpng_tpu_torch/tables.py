"""Pre-trained Huffman tables for the 1-pass encoder, and the same tables as
torch tensors.

fpng ships tables trained on a private corpus (fpng.cpp:530-562, produced by
its `-t` mode).  We train our own: the same pipeline - per-image scaled
histograms accumulated into 64-bit counts, all-symbols-codable forcing, the
12-bit-limited table build, and a serialized zlib+dynamic-block-header
prefix with its leftover bit-accumulator state (create_dynamic_block_prefix,
fpng.cpp:909-987) - but fed by a deterministic synthetic corpus spanning
flat/gradient/photo/noise/sprite statistics (fpng_tpu_torch.train).

The checked-in artifact lives in _tables_data.py, a copy of fpng_tpu's
(regenerate with `python -m fpng_tpu_torch.train`).  Loading falls back to
on-the-fly training if the artifact is missing.  The host half of this
module is a copy of fpng_tpu/tables.py; one_pass_state turns its arrays
into the encoder's tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import constants as C
from .bitio import BitWriter
from .huffman import adjust_freq32, build_tables, emit_dynamic_block_header
from .models.transfer import to_device
from .ops.encfuse import pack_table

# artifact: (prefix_bytes, pending_bits, pending_count, codes_u32, sizes_u8)
OnePassTables = tuple


def train_tables_from_freqs(freq64: np.ndarray, num_chans: int) -> OnePassTables:
    """Build the reusable 1-pass block prefix from accumulated counts.

    Mirrors create_dynamic_block_prefix: scale 64-bit counts into uint32
    (halving until they fit), force every literal/EOB and every legal match
    length codable, then emit zlib hdr + BFINAL + dynamic block header.
    """
    freq = np.asarray(freq64, dtype=np.uint64).copy()
    shift = 0
    while True:
        f = np.where(freq != 0, np.maximum(np.uint64(1), freq >> np.uint64(shift)), 0)
        if int(f.max()) <= 0xFFFFFFFF:
            break
        shift += 1
    lit_freq = f.astype(np.uint64)
    lit_freq[:257] = np.maximum(lit_freq[:257], 1)
    for length in range(num_chans, 259, num_chans):
        sym = int(C.LEN_SYM[length - 3])
        if lit_freq[sym] == 0:
            lit_freq[sym] = 1

    # build_tables() re-applies adjust_freq32 internally; feed it the
    # sanitized 32-bit counts directly (it scales to uint16 itself).
    tables = build_tables(lit_freq, num_chans)

    w = BitWriter()
    w.put_and_drain(C.ZLIB_HDR0, 8)
    w.put_and_drain(C.ZLIB_HDR1, 8)
    w.put_and_drain(1, 1)  # BFINAL
    emit_dynamic_block_header(w, tables)
    acc, nacc = w.pending
    w._acc, w._nacc = 0, 0  # detach pending bits; they ride in the artifact
    prefix = w.getvalue()
    return (prefix, acc, nacc,
            tables.lit_codes.astype(np.uint32),
            tables.lit_sizes.astype(np.uint8))


def accumulate_image_freqs(img: np.ndarray, into: np.ndarray) -> None:
    """Add one image's scaled histogram into 64-bit accumulators.

    Matches the reference trainer: the per-image histogram is first scaled
    by adjust_freq32 (as the 2-pass encoder does) and those uint16 counts
    are what accumulate (fpng.cpp:751-755 + fpng_test.cpp:864-878).
    """
    from .golden import filter_image, histogram_tokens, tokenize_image

    c = img.shape[2]
    filtered = filter_image(img)
    freq = histogram_tokens(tokenize_image(filtered, c))
    into += adjust_freq32(freq).astype(np.uint64)


_CACHE: dict[int, OnePassTables] = {}


def get_one_pass_tables(num_chans: int) -> OnePassTables:
    if num_chans in _CACHE:
        return _CACHE[num_chans]
    try:
        from . import _tables_data as td
        art = (bytes(td.PREFIX[num_chans]), td.PENDING[num_chans][0],
               td.PENDING[num_chans][1],
               np.asarray(td.CODES[num_chans], dtype=np.uint32),
               np.asarray(td.SIZES[num_chans], dtype=np.uint8))
    except ImportError:  # artifact missing: train on the synthetic corpus
        from .train import train_default_tables
        art = train_default_tables(num_chans)
    _CACHE[num_chans] = art
    return art


class OnePassState(NamedTuple):
    prefix: bytes          # zlib header + dynamic block header bytes
    acc: int               # pending sub-byte tail of the prefix ...
    nacc: int              # ... and its bit count (<= 7)
    codes: torch.Tensor    # (288,) int64 literal/length codes
    sizes: torch.Tensor    # (288,) int64 code lengths
    tbl: torch.Tensor      # (8, 128) int32 packed code | size << 16


def one_pass_state(num_chans: int, device,
                   tables: OnePassTables | None = None) -> OnePassState:
    """The 1-pass tables for `num_chans` channels as tensors on `device`.

    `tables` is a (prefix, acc, nacc, codes, sizes) tuple of numpy arrays,
    as get_one_pass_tables (or fpng_tpu.tables') returns it; by default
    the port's own copy.
    """
    if tables is None:
        tables = get_one_pass_tables(num_chans)
    prefix, acc, nacc, codes, sizes = tables
    codes_t, sizes_t = (to_device(np.asarray(a).astype(np.int64), device)
                        for a in (codes, sizes))
    tbl = pack_table(codes_t[None], sizes_t[None])[0]
    return OnePassState(bytes(prefix), int(acc), int(nacc), codes_t, sizes_t,
                        tbl)
