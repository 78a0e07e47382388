"""Length-limited canonical Huffman construction + dynamic block header codec.

Host-side (NumPy/Python): tables are tiny (288/32/19 symbols) so this is
container-layer work, not kernel work.  The construction reproduces the
reference encoder's table pipeline *exactly* — stable frequency sort,
Moffat/Katajainen minimum-redundancy lengths (uint16 arithmetic), Kraft
max-code-size fixup, canonical bit-reversed codes, and the RLE-compressed
dynamic block header — so 2-pass outputs are byte-identical to fpng's
(reference behavior: fpng.cpp:607-816).  The algorithms themselves are the
standard published ones (Moffat & Katajainen 1996; RFC 1951 3.2.7).
"""

from __future__ import annotations

import numpy as np

from .bitio import BitWriter
from .constants import (
    CLEN_CODE_LIMIT,
    CLEN_ORDER,
    DIST_SYM,
    LIT_CODE_LIMIT,
    NUM_CLEN_SYMS,
    NUM_DIST_SYMS,
    NUM_LIT_SYMS,
)

_U16 = 0xFFFF


def _minimum_redundancy_inplace(A: list[int]) -> None:
    """Moffat/Katajainen in-place minimum-redundancy code lengths.

    `A` holds frequencies sorted ascending; on return it holds code lengths.
    Arithmetic wraps at 16 bits to match the reference's uint16 keys.
    """
    n = len(A)
    if n == 0:
        return
    if n == 1:
        A[0] = 1
        return
    # Phase 1: build the tree in place (indices overwrite freqs).
    A[0] = (A[0] + A[1]) & _U16
    root, leaf = 0, 2
    for nxt in range(1, n - 1):
        if leaf >= n or A[root] < A[leaf]:
            A[nxt] = A[root]
            A[root] = nxt & _U16
            root += 1
        else:
            A[nxt] = A[leaf]
            leaf += 1
        if leaf >= n or (root < nxt and A[root] < A[leaf]):
            A[nxt] = (A[nxt] + A[root]) & _U16
            A[root] = nxt & _U16
            root += 1
        else:
            A[nxt] = (A[nxt] + A[leaf]) & _U16
            leaf += 1
    # Phase 2: internal node depths.
    A[n - 2] = 0
    for nxt in range(n - 3, -1, -1):
        A[nxt] = (A[A[nxt]] + 1) & _U16
    # Phase 3: leaf depths from internal depths.
    avbl, used, dpth = 1, 0, 0
    root, nxt = n - 2, n - 1
    while avbl > 0:
        while root >= 0 and A[root] == dpth:
            used += 1
            root -= 1
        while avbl > used:
            A[nxt] = dpth
            nxt -= 1
            avbl -= 1
        avbl = 2 * used
        dpth += 1
        used = 0


def _enforce_max_code_size(num_codes: list[int], code_list_len: int,
                           max_code_size: int) -> None:
    """Kraft fixup: fold lengths > max into max, then re-balance."""
    if code_list_len <= 1:
        return
    for i in range(max_code_size + 1, 33):
        num_codes[max_code_size] += num_codes[i]
        num_codes[i] = 0
    total = 0
    for i in range(max_code_size, 0, -1):
        total += num_codes[i] << (max_code_size - i)
    while total != (1 << max_code_size):
        num_codes[max_code_size] -= 1
        for i in range(max_code_size - 1, 0, -1):
            if num_codes[i]:
                num_codes[i] -= 1
                num_codes[i + 1] += 2
                break
        total -= 1


def _bitrev(code: int, nbits: int) -> int:
    r = 0
    for _ in range(nbits):
        r = (r << 1) | (code & 1)
        code >>= 1
    return r


def build_code_sizes(freqs: np.ndarray, limit: int) -> tuple[np.ndarray, list[int]]:
    """Code sizes (0 = unused) for a (uint16-scaled) frequency table.

    Ties are broken exactly like the reference: stable ascending sort by
    frequency, then lengths are assigned shortest-first walking the sorted
    array from its high end.
    """
    n = len(freqs)
    used = [(int(f), i) for i, f in enumerate(freqs) if f]
    used.sort(key=lambda t: t[0])  # stable: ties keep symbol-index order
    A = [f for f, _ in used]
    _minimum_redundancy_inplace(A)
    num_codes = [0] * 33
    for length in A:
        num_codes[length] += 1
    _enforce_max_code_size(num_codes, len(used), limit)
    sizes = np.zeros(n, dtype=np.uint8)
    j = len(used)
    for i in range(1, limit + 1):
        for _ in range(num_codes[i]):
            j -= 1
            sizes[used[j][1]] = i
    return sizes, num_codes


def canonical_codes(sizes: np.ndarray, num_codes: list[int] | None = None,
                    limit: int = 15) -> np.ndarray:
    """Canonical codes (bit-reversed for LSB-first emission)."""
    if num_codes is None:
        num_codes = [0] * 33
        for s in sizes:
            if s:
                num_codes[int(s)] += 1
    next_code = [0] * (limit + 2)
    j = 0
    for i in range(2, limit + 1):
        j = (j + num_codes[i - 1]) << 1
        next_code[i] = j
    codes = np.zeros(len(sizes), dtype=np.uint16)
    for i, s in enumerate(sizes):
        s = int(s)
        if s == 0:
            continue
        code = next_code[s]
        next_code[s] += 1
        codes[i] = _bitrev(code, s)
    return codes


def adjust_freq32(freqs: np.ndarray) -> np.ndarray:
    """Scale 32/64-bit frequencies into uint16 preserving non-zero-ness."""
    freqs = np.asarray(freqs, dtype=np.uint64)
    total = int(freqs.sum())
    out = np.zeros(len(freqs), dtype=np.uint16)
    if total == 0:
        return out
    nz = freqs != 0
    scaled = (freqs[nz] * np.uint64(0xFFFF)) // np.uint64(total)
    out[nz] = np.maximum(np.uint64(1), scaled).astype(np.uint16)
    return out


class HuffTables:
    """Literal/length + distance code tables for one dynamic block."""

    __slots__ = ("lit_sizes", "lit_codes", "dist_sizes", "dist_codes")

    def __init__(self, lit_sizes, lit_codes, dist_sizes, dist_codes):
        self.lit_sizes = lit_sizes
        self.lit_codes = lit_codes
        self.dist_sizes = dist_sizes
        self.dist_codes = dist_codes


def build_tables(lit_freq: np.ndarray, num_chans: int) -> HuffTables:
    """Build per-image tables from a 288-bin literal/length histogram.

    `lit_freq` must already include the forced EOB count (lit_freq[256]=1).
    The distance table is the fixed two-code table {dist_sym, dist_sym+1}
    (the second code exists only to satisfy wuffs' strictness).
    """
    freq16 = adjust_freq32(lit_freq)
    # The reference re-forces the EOB count to raw 1 *after* scaling
    # (fpng.cpp:757), so EOB competes with key 1, not its scaled value.
    freq16[256] = 1
    lit_sizes, lit_nc = build_code_sizes(freq16, LIT_CODE_LIMIT)
    lit_codes = canonical_codes(lit_sizes, lit_nc, LIT_CODE_LIMIT)

    dist_freq = np.zeros(NUM_DIST_SYMS, dtype=np.uint16)
    ds = DIST_SYM[num_chans]
    dist_freq[ds] = 1
    dist_freq[ds + 1] = 1
    dist_sizes, dist_nc = build_code_sizes(dist_freq, LIT_CODE_LIMIT)
    dist_codes = canonical_codes(dist_sizes, dist_nc, LIT_CODE_LIMIT)
    assert dist_sizes[ds] == 1 and dist_codes[ds] == 0
    return HuffTables(lit_sizes, lit_codes, dist_sizes, dist_codes)


def _pack_code_sizes(sizes: np.ndarray) -> tuple[list[tuple[int, int | None]], np.ndarray]:
    """RLE-compress concatenated code sizes (RFC 1951 3.2.7 syms 16/17/18).

    Returns (packed, clen_freq): packed items are (sym, extra) with extra
    None for plain sizes.
    """
    packed: list[tuple[int, int | None]] = []
    freq = np.zeros(NUM_CLEN_SYMS, dtype=np.uint16)
    rle_z = 0
    rle_rep = 0
    prev = 0xFF

    def flush_prev():
        nonlocal rle_rep
        if rle_rep:
            if rle_rep < 3:
                freq[prev] += rle_rep
                packed.extend((prev, None) for _ in range(rle_rep))
            else:
                freq[16] += 1
                packed.append((16, rle_rep - 3))
            rle_rep = 0

    def flush_zero():
        nonlocal rle_z
        if rle_z:
            if rle_z < 3:
                freq[0] += rle_z
                packed.extend((0, None) for _ in range(rle_z))
            elif rle_z <= 10:
                freq[17] += 1
                packed.append((17, rle_z - 3))
            else:
                freq[18] += 1
                packed.append((18, rle_z - 11))
            rle_z = 0

    for size in sizes:
        size = int(size)
        if size == 0:
            flush_prev()
            rle_z += 1
            if rle_z == 138:
                flush_zero()
        else:
            flush_zero()
            if size != prev:
                flush_prev()
                freq[size] += 1
                packed.append((size, None))
            else:
                rle_rep += 1
                if rle_rep == 6:
                    flush_prev()
        prev = size
    if rle_rep:
        flush_prev()
    else:
        flush_zero()
    return packed, freq


_CLEN_EXTRA_BITS = {16: 2, 17: 3, 18: 7}


def emit_dynamic_block_header(w: BitWriter, t: HuffTables) -> None:
    """Emit BTYPE + the dynamic Huffman block header (not BFINAL)."""
    lit_sizes, dist_sizes = t.lit_sizes, t.dist_sizes
    num_lit = 286
    while num_lit > 257 and lit_sizes[num_lit - 1] == 0:
        num_lit -= 1
    num_dist = 30
    while num_dist > 1 and dist_sizes[num_dist - 1] == 0:
        num_dist -= 1

    concat = np.concatenate([lit_sizes[:num_lit], dist_sizes[:num_dist]])
    packed, clen_freq = _pack_code_sizes(concat)

    clen_sizes, clen_nc = build_code_sizes(clen_freq, CLEN_CODE_LIMIT)
    clen_codes = canonical_codes(clen_sizes, clen_nc, CLEN_CODE_LIMIT)

    w.put_and_drain(2, 2)  # BTYPE = dynamic
    w.put_and_drain(num_lit - 257, 5)
    w.put_and_drain(num_dist - 1, 5)

    nbl = 18
    while nbl >= 0 and clen_sizes[CLEN_ORDER[nbl]] == 0:
        nbl -= 1
    nbl = max(4, nbl + 1)
    w.put_and_drain(nbl - 4, 4)
    for i in range(nbl):
        w.put_and_drain(int(clen_sizes[CLEN_ORDER[i]]), 3)

    for sym, extra in packed:
        w.put_and_drain(int(clen_codes[sym]), int(clen_sizes[sym]))
        if sym >= 16:
            w.put_and_drain(extra, _CLEN_EXTRA_BITS[sym])


# ---------------------------------------------------------------------------
# Decode side
# ---------------------------------------------------------------------------

DECODER_TABLE_SIZE = 1 << 12


def build_decoder_table(num_syms: int, sizes: np.ndarray) -> np.ndarray | None:
    """12-bit lookup table: entry = sym | (code_len << 9). None if invalid.

    Accepts complete trees, or the degenerate single-code tree (Kraft
    total != 2^16 is only allowed when exactly one code exists).
    """
    num_codes = np.zeros(16, dtype=np.int64)
    for i in range(num_syms):
        s = int(sizes[i])
        if s > 15:
            return None
        num_codes[s] += 1
    next_code = np.zeros(17, dtype=np.int64)
    total = 0
    for i in range(1, 16):
        total = (total + int(num_codes[i])) << 1
        next_code[i + 1] = total
    if total != 0x10000:
        if int(num_codes[1:].sum()) != 1:
            return None

    table = np.zeros(DECODER_TABLE_SIZE, dtype=np.uint32)
    for i in range(num_syms):
        size = int(sizes[i])
        if not size:
            continue
        code = int(next_code[size])
        next_code[size] += 1
        rev = _bitrev(code, size)
        step = 1 << size
        entry = np.uint32(i | (size << 9))
        table[rev::step] = entry
    return table
