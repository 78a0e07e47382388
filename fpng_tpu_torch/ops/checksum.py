"""Checksums as parallel reductions (counterpart of fpng_tpu/ops/checksum.py).

Adler-32: the (A, B) update is affine, so the checksum decomposes into
per-chunk (sum, weighted sum) pairs combined with modular arithmetic.

CRC-32: the init-0 ("raw") register is GF(2)-linear in the message, so it is
the XOR of per-(position, bit) contributions; chunk registers combine in a
log-depth tree with x^(8*L*2^t) mod P shift matrices.  The matrices and
tables are host numpy/Python (copied from the JAX package, which keeps them
in modules that import jax); their application is torch ops on int64
registers masked to 32 bits.  This is the plain side of kernel B2 on any
device; the whole IDAT CRC in one launch is ops/assemble.py:idat_crc_words
(csrc/crc_words.cu).

The byte-array CRC (crc32_raw, crc32_bytes, crc32_bytes_var) is torch ops
on whatever device its input is on, and has no kernel: fpng_tpu computes
it in XLA, with no Pallas kernel to port.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .bitpack import from_word32

ADLER_MOD = 65521
_ADLER_CHUNK = 1024


def adler32_bytes(data: torch.Tensor) -> torch.Tensor:
    """Adler-32 of each row of a (B, N) uint8 tensor -> (B,) int64."""
    B, N = data.shape
    L = _ADLER_CHUNK
    dev = data.device
    d = torch.nn.functional.pad(data.to(torch.int64), (0, (-N) % L))
    Kc = d.shape[1] // L
    d = d.reshape(B, Kc, L)
    w = torch.arange(L, 0, -1, dtype=torch.int64, device=dev)  # weights L..1
    s1 = d.sum(dim=2)
    s2 = (d * w).sum(dim=2)
    # true chunk lengths: the zero padding of a short final chunk adds
    # nothing to s1, but s2 weighted it L-j instead of len-j
    lens = torch.clamp(N - torch.arange(Kc, dtype=torch.int64, device=dev) * L,
                       0, L)
    s1m = s1 % ADLER_MOD
    s2c = (s2 - (L - lens) * s1) % ADLER_MOD
    a_before = (1 + torch.cumsum(s1m, dim=1) - s1m) % ADLER_MOD
    terms = ((lens % ADLER_MOD) * a_before + s2c) % ADLER_MOD
    b_fin = terms.sum(dim=1) % ADLER_MOD
    a_fin = (1 + s1m.sum(dim=1)) % ADLER_MOD
    return (b_fin << 16) | a_fin


# ---------------------------------------------------------------------------
# CRC-32 (PNG polynomial, reflected algorithm): host-side GF(2) tables
# ---------------------------------------------------------------------------

_CRC_POLY = 0xEDB88320
_CRC_CHUNK = 256


@functools.lru_cache(maxsize=None)
def _byte_table() -> tuple:
    t = np.zeros(256, np.uint32)
    for b in range(256):
        c = b
        for _ in range(8):
            c = (c >> 1) ^ (_CRC_POLY if c & 1 else 0)
        t[b] = c
    return tuple(int(x) for x in t)


def _advance_byte(vals: np.ndarray) -> np.ndarray:
    """Advance raw CRC registers through one zero byte."""
    t = np.asarray(_byte_table(), np.uint32)
    return (vals >> np.uint32(8)) ^ t[vals & np.uint32(0xFF)]


@functools.lru_cache(maxsize=None)
def _shift1_matrix() -> tuple:
    """Shift-by-one-byte GF(2) matrix as 32 uint32 basis images."""
    basis = np.array([np.uint32(1) << b for b in range(32)], np.uint32)
    return tuple(int(x) for x in _advance_byte(basis))


def _gf2_compose(m2: tuple, m1: tuple) -> tuple:
    """(m2 after m1) as basis images: out[b] = m2(m1[b])."""
    out = []
    for b in range(32):
        v = m1[b]
        acc = 0
        for k in range(32):
            if (v >> k) & 1:
                acc ^= m2[k]
        out.append(acc)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _shift_pow2_matrix(t: int) -> tuple:
    """Matrix advancing a CRC register through 2^t zero bytes."""
    if t == 0:
        return _shift1_matrix()
    m = _shift_pow2_matrix(t - 1)
    return _gf2_compose(m, m)


@functools.lru_cache(maxsize=None)
def _shift_matrix(nbytes: int) -> tuple:
    """Matrix advancing a CRC register through `nbytes` zero bytes."""
    m = tuple(1 << b for b in range(32))  # identity
    t = 0
    while nbytes:
        if nbytes & 1:
            m = _gf2_compose(_shift_pow2_matrix(t), m)
        nbytes >>= 1
        t += 1
    return m


def _shift_crc(nbytes: int, crc: int) -> int:
    """A host register advanced through `nbytes` zero bytes."""
    m = _shift_matrix(nbytes)
    acc = 0
    for b in range(32):
        if (crc >> b) & 1:
            acc ^= m[b]
    return acc


@functools.lru_cache(maxsize=None)
def _inv_shift1_matrix() -> tuple:
    """GF(2) inverse of the shift-by-one-byte matrix (basis images)."""
    fwd = _shift1_matrix()
    # Gauss-Jordan over GF(2); rows[r] bit b = (fwd[b] >> r) & 1
    rows = []
    for r in range(32):
        v = 0
        for b in range(32):
            v |= ((fwd[b] >> r) & 1) << b
        rows.append(v)
    eye = [1 << r for r in range(32)]
    for col in range(32):
        piv = next(r for r in range(col, 32) if (rows[r] >> col) & 1)
        rows[col], rows[piv] = rows[piv], rows[col]
        eye[col], eye[piv] = eye[piv], eye[col]
        for r in range(32):
            if r != col and (rows[r] >> col) & 1:
                rows[r] ^= rows[col]
                eye[r] ^= eye[col]
    # eye holds M^{-1} in row form: bit b of eye[r] = M^{-1}[r, b]
    out = []
    for b in range(32):
        v = 0
        for r in range(32):
            v |= ((eye[r] >> b) & 1) << r
        out.append(v)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _inv_shift_pow2_matrix(t: int) -> tuple:
    """Matrix reversing a CRC register through 2^t zero bytes."""
    if t == 0:
        return _inv_shift1_matrix()
    m = _inv_shift_pow2_matrix(t - 1)
    return _gf2_compose(m, m)


@functools.lru_cache(maxsize=None)
def _position_bit_table(chunk: int) -> np.ndarray:
    """(chunk, 8) uint32: contribution of bit k of byte j to the raw CRC
    register of a `chunk`-byte block."""
    t = np.asarray(_byte_table(), np.uint32)
    bit = np.zeros((chunk, 8), np.uint32)
    cur = t[np.uint32(1) << np.arange(8)]  # final byte's bit contributions
    for j in range(chunk - 1, -1, -1):
        bit[j] = cur
        cur = _advance_byte(cur)
    return bit


_WCRC_CW = 1024  # words per chunk register (4096 bytes)


@functools.lru_cache(maxsize=None)
def _word_bit_table() -> np.ndarray:
    """(32, 1024) uint32: contribution of bit k of LE word j to the raw CRC
    register of a 4096-byte chunk."""
    byte_tab = np.array(_position_bit_table(_WCRC_CW * 4), np.uint32)
    j = np.arange(_WCRC_CW)
    out = np.zeros((32, _WCRC_CW), np.uint32)
    for k in range(32):
        out[k] = byte_tab[4 * j + k // 8, k % 8]
    return out


@functools.lru_cache(maxsize=None)
def _bit_table_4() -> np.ndarray:
    """(32,) uint32: contribution of bit k of an LE word to the raw CRC of
    its own 4 bytes as a standalone message."""
    t = np.array(_position_bit_table(4), np.uint32)  # (4, 8)
    return np.array([t[k // 8, k % 8] for k in range(32)], np.uint32)


SHIFT_LEVELS = 32  # 2^t-byte shift matrices, t < 32


@functools.lru_cache(maxsize=None)
def _shift_tables() -> np.ndarray:
    """(2 * SHIFT_LEVELS + 1, 32) uint32: the 2^t-byte shift matrices, their
    inverses and the 4-byte LE word table, each as 32 basis images (the
    tables B2's finish applies, csrc/crc_words.cu)."""
    rows = [_shift_pow2_matrix(t) for t in range(SHIFT_LEVELS)] + \
        [_inv_shift_pow2_matrix(t) for t in range(SHIFT_LEVELS)] + \
        [tuple(int(x) for x in _bit_table_4())]
    return np.array(rows, np.uint32)


def crc32_raw_prefix_host(msgs: list[bytes]) -> np.ndarray:
    """Host-side raw (init-0) CRC registers of short per-image messages,
    vectorized over the batch with the byte table."""
    t = np.asarray(_byte_table(), np.uint32)
    B = len(msgs)
    n = max((len(m) for m in msgs), default=0)
    buf = np.zeros((B, n), np.uint8)
    lens = np.zeros(B, np.int64)
    for b, m in enumerate(msgs):
        buf[b, :len(m)] = np.frombuffer(m, np.uint8)
        lens[b] = len(m)
    r = np.zeros(B, np.uint32)
    for j in range(n):
        step = (r >> np.uint32(8)) ^ t[(r ^ buf[:, j]) & np.uint32(0xFF)]
        r = np.where(j < lens, step, r)
    return r


# ---------------------------------------------------------------------------
# GF(2) register math in torch (int64 registers holding uint32 values)
# ---------------------------------------------------------------------------


def _xor_reduce_last(x: torch.Tensor) -> torch.Tensor:
    """XOR over the last axis (a power of two long)."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] ^ x[..., h:]
    return x[..., 0]


def _apply_rows(crc: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Apply a GF(2) matrix given as (..., 32) basis images to registers."""
    bits = (crc.unsqueeze(-1) >> torch.arange(32, device=crc.device)) & 1
    return _xor_reduce_last(bits * rows)


@functools.lru_cache(maxsize=None)
def _rows_on(rows: tuple, device: torch.device) -> torch.Tensor:
    """A host GF(2) matrix (32 basis images) as an int64 tensor on device,
    uploaded once per device."""
    return torch.tensor(rows, dtype=torch.int64).to(device)


def _apply_shift_device(crc: torch.Tensor, rows: tuple) -> torch.Tensor:
    """Apply one host GF(2) matrix (32 basis images) to (B,) registers."""
    return _apply_rows(crc, _rows_on(rows, crc.device))


def _var_shift(raw, k, max_k, matrix):
    k = torch.clamp(k.to(torch.int64), min=0)
    for t in range(max(int(max_k).bit_length(), 1)):
        shifted = _apply_shift_device(raw, matrix(t))
        raw = torch.where(((k >> t) & 1) == 1, shifted, raw)
    return raw


def crc32_var_unshift(raw: torch.Tensor, k: torch.Tensor,
                      max_k: int) -> torch.Tensor:
    """Reverse each raw register through k[b] (< max_k) zero bytes."""
    return _var_shift(raw, k, max_k, _inv_shift_pow2_matrix)


def crc32_var_shift(raw: torch.Tensor, k: torch.Tensor,
                    max_k: int) -> torch.Tensor:
    """Advance each raw register through k[b] (<= max_k) zero bytes."""
    return _var_shift(raw, k, max_k, _shift_pow2_matrix)


def crc32_raw4_le(word: torch.Tensor) -> torch.Tensor:
    """Raw (init-0) CRC register of the 4 bytes of each LE uint32."""
    return _apply_shift_device(word, tuple(int(x) for x in _bit_table_4()))


# ---------------------------------------------------------------------------
# Word-domain raw CRC (device container assembly)
# ---------------------------------------------------------------------------


def _ones_below(c: torch.Tensor) -> torch.Tensor:
    """Mask of the low 8*c bits, c in [0, 4] (int64)."""
    m = (torch.ones_like(c) << (8 * torch.clamp(c, max=3))) - 1
    return torch.where(c >= 4, 0xFFFFFFFF, m)


@functools.lru_cache(maxsize=None)
def _word_table_on(device: torch.device) -> torch.Tensor:
    """_word_bit_table() as (32, 1024) int32 bit patterns on device,
    uploaded once per device (128 KB)."""
    return torch.from_numpy(_word_bit_table().view(np.int32)).to(device)


@functools.lru_cache(maxsize=None)
def _shift_tables_on(device: torch.device) -> torch.Tensor:
    """_shift_tables() as int32 bit patterns on device, uploaded once per
    device (8.3 KB)."""
    return torch.from_numpy(_shift_tables().view(np.int32)).to(device)


def crc_chunks_plain(words: torch.Tensor, lo: torch.Tensor,
                     hi: torch.Tensor) -> torch.Tensor:
    """B2's chunk pass as torch ops: (B, NW) int32 words -> (B, NW/1024)
    int64 raw chunk registers, bytes outside [lo, hi) read as zero."""
    B, NW = words.shape
    Kc = NW // _WCRC_CW
    dev = words.device
    w = from_word32(words).reshape(B, Kc, _WCRC_CW)
    p = 4 * torch.arange(NW, dtype=torch.int64, device=dev).reshape(
        1, Kc, _WCRC_CW)
    lo = lo.to(torch.int64)[:, None, None]
    hi = hi.to(torch.int64)[:, None, None]
    mask = (~_ones_below(torch.clamp(lo - p, 0, 4)) & 0xFFFFFFFF) & \
        _ones_below(torch.clamp(hi - p, 0, 4))
    wm = w & mask
    tab = _word_table_on(dev).to(torch.int64) & 0xFFFFFFFF
    acc = torch.zeros_like(wm)
    for k in range(32):
        acc ^= ((wm >> k) & 1) * tab[k]
    return _xor_reduce_last(acc)


def combine_chunks(acc: torch.Tensor,
                   span: int = _WCRC_CW * 4) -> torch.Tensor:
    """Fold (B, K) raw registers of consecutive `span`-byte chunks into one
    per row with a log-depth shift-combine tree (odd levels get a
    raw-neutral zero segment prepended)."""
    B, Kc = acc.shape
    while Kc > 1:
        if Kc % 2:
            acc = torch.cat([torch.zeros_like(acc[:, :1]), acc], dim=1)
            Kc += 1
        left, right = acc[:, 0::2], acc[:, 1::2]
        acc = _apply_shift_device(left, _shift_matrix(span)) ^ right
        span *= 2
        Kc //= 2
    return acc[:, 0]


def crc32_words_masked_raw(words: torch.Tensor, lo: torch.Tensor,
                           hi: torch.Tensor) -> torch.Tensor:
    """Init-0 CRC register of each row of a (B, NW) int32 LE word buffer
    with bytes outside [lo[b], hi[b]) treated as zero.  NW must be a
    multiple of 1024; the result (B,) int64 is the raw register of the
    full 4*NW-byte masked message.  Torch ops on any device: the plain
    version of kernel B2's chunk pass and combine."""
    if words.shape[1] % _WCRC_CW:
        raise ValueError(f"word count {words.shape[1]} is not a multiple of "
                         f"{_WCRC_CW}")
    return combine_chunks(crc_chunks_plain(words, lo, hi))


# ---------------------------------------------------------------------------
# Byte-array CRC-32 (torch ops on the input's device; no kernel, see above)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _position_table_on(chunk: int, device: torch.device) -> torch.Tensor:
    """_position_bit_table(chunk) as (chunk, 8) int64 on device, uploaded
    once per device."""
    return torch.from_numpy(_position_bit_table(chunk).astype(np.int64)).to(
        device)


def crc32_raw(data: torch.Tensor) -> torch.Tensor:
    """Init-0 CRC register ("raw") of each row of a (B, N) byte tensor ->
    (B,) int64.

    raw() is GF(2)-linear in the message and leading zero bytes are
    raw-neutral, so the rows are front-padded to 256-byte chunks, each
    chunk's register is the XOR of its bits' position contributions, and
    the chunks combine with shift matrices in a log-depth tree.
    """
    B, N = data.shape
    L = _CRC_CHUNK
    d = torch.nn.functional.pad(data.to(torch.int64), ((-N) % L, 0))
    d = d.reshape(B, max(d.shape[1] // L, 1), L)
    bit = _position_table_on(L, data.device)
    acc = torch.zeros(d.shape[:2], dtype=torch.int64, device=data.device)
    for k in range(8):
        acc ^= _xor_reduce_last(((d >> k) & 1) * bit[:, k])
    return combine_chunks(acc, L)


def crc32_bytes(data: torch.Tensor) -> torch.Tensor:
    """Standard CRC-32 of each row of a (B, N) uint8 tensor -> (B,) int64.

    crc(msg) = raw(msg) ^ shift_N(0xFFFFFFFF) ^ 0xFFFFFFFF.
    """
    init = _shift_crc(data.shape[1], 0xFFFFFFFF)
    return crc32_raw(data) ^ init ^ 0xFFFFFFFF


def crc32_bytes_var(data: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """CRC-32 of data[b, :lens[b]] for each row -> (B,) int64.  Bytes at
    idx >= lens[b] MUST already be zero (the caller masks them): with
    trailing zeros raw(msg || 0^k) = shift_k(raw(msg)), so each register
    is unshifted through its k = N - lens[b] zero bytes."""
    N = data.shape[1]
    raw = crc32_raw(data) ^ _shift_crc(N, 0xFFFFFFFF)
    return crc32_var_unshift(raw, N - lens.to(torch.int64), N) ^ 0xFFFFFFFF
