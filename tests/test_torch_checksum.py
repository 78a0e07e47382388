"""fpng_tpu_torch's checksums against fpng_tpu's and zlib, on the CPU.

adler32_bytes, the plain B2 chunk reduction with its combine tree, the
GF(2) register shifts and the IDAT CRC assembly (idat_crc_words_plain, on
the edge cases of the kernel: odd chunk counts, one chunk, no zero tail, a
payload inside the first chunk, no prefix, per-image prefixes) must equal
the JAX functions (Pallas kernels in interpret mode) and zlib bit for bit.
A numpy twin of kernel B2's arithmetic (each chunk register shifted by the
zero bytes after it with the 2^t-byte tables, XORed, then the finish with
the same tables) is held against the plain version and zlib.  The
byte-array CRC (crc32_raw, crc32_bytes, crc32_bytes_var: torch ops, no
kernel) is held against fpng_tpu's jitted functions and zlib.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpng_tpu.ops import assemble as JA
from fpng_tpu.ops import checksum as JC
from fpng_tpu_torch.ops import assemble as TA
from fpng_tpu_torch.ops import checksum as TC


@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 5000, 70001])
def test_adler32_matches_zlib_and_jax(n):
    rng = np.random.default_rng(n)
    data = rng.integers(0, 256, (3, n), dtype=np.uint8)
    data[1] = 255  # worst case for the modular sums
    got = TC.adler32_bytes(torch.from_numpy(data)).numpy()
    assert [int(g) for g in got] == [zlib.adler32(r.tobytes()) for r in data]
    assert np.array_equal(got, np.asarray(JC.adler32_bytes(
        jnp.asarray(data))).astype(np.int64))


@pytest.mark.parametrize("n", [1, 7, 255, 256, 257, 1024, 4096, 70001])
def test_crc32_bytes_matches_zlib_and_jax(n):
    rng = np.random.default_rng(n)
    data = rng.integers(0, 256, (3, n), dtype=np.uint8)
    data[1] = 0  # leading zeros are raw-neutral, trailing ones are not
    t = torch.from_numpy(data)
    raw = TC.crc32_raw(t)
    assert np.array_equal(raw.numpy(), np.asarray(jax.jit(JC.crc32_raw)(
        jnp.asarray(data))).astype(np.int64))
    got = TC.crc32_bytes(t)
    assert [int(g) for g in got] == [zlib.crc32(r.tobytes()) for r in data]
    assert np.array_equal(got.numpy(), np.asarray(jax.jit(JC.crc32_bytes)(
        jnp.asarray(data))).astype(np.int64))
    assert TC._shift_crc(n, 0xFFFFFFFF) == JC._shift_crc(n, 0xFFFFFFFF)
    assert TC._CRC_CHUNK == JC._CRC_CHUNK


@pytest.mark.parametrize("n", [1, 256, 257, 4096, 70001])
def test_crc32_bytes_var_matches_zlib_and_jax(n):
    """Ragged lengths, 0 and N among them, the tails zeroed."""
    rng = np.random.default_rng(n + 1)
    lens = np.array([0, n, *rng.integers(0, n + 1, 3), n // 2], np.int32)
    data = rng.integers(0, 256, (len(lens), n), dtype=np.uint8)
    data[np.arange(n)[None, :] >= lens[:, None]] = 0
    got = TC.crc32_bytes_var(torch.from_numpy(data), torch.from_numpy(lens))
    assert [int(g) for g in got] == [zlib.crc32(r[:k].tobytes())
                                     for r, k in zip(data, lens)]
    want = jax.jit(JC.crc32_bytes_var)(jnp.asarray(data), jnp.asarray(lens))
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def _words(rng, B, NW):
    return rng.integers(0, 2**32, (B, NW), np.uint64).astype(np.uint32)


@pytest.mark.parametrize("K", [1, 2, 5])
def test_b2_plain_matches_jax_interpret(K):
    rng = np.random.default_rng(K)
    B, NW = 4, K * 1024
    words = _words(rng, B, NW)
    lo = np.array([0, 5, 61, 4097 % (4 * NW)], np.int32)
    hi = np.array([4 * NW, 4 * NW - 3, 2 * NW + 1, 4 * NW - 18], np.int32)
    want = np.asarray(JC.crc32_words_masked_raw(
        jnp.asarray(words), jnp.asarray(lo), jnp.asarray(hi),
        interpret=True)).astype(np.int64)
    tw = torch.from_numpy(words.view(np.int32))
    got = TC.crc32_words_masked_raw(tw, torch.from_numpy(lo),
                                    torch.from_numpy(hi))
    assert np.array_equal(got.numpy(), want)
    # the whole IDAT CRC's wrapper on a CPU tensor is its plain version
    tbits = torch.from_numpy(hi.astype(np.int64) * 8)
    adler = torch.from_numpy(np.arange(B, dtype=np.int64) * 0x01020304)
    raw_ip = np.arange(B, dtype=np.int64) * 0x9E3779B1 % 2**32
    assert torch.equal(TA.idat_crc_words(tw, tbits, adler, lo, raw_ip),
                       TA.idat_crc_words_plain(tw, tbits, adler, lo, raw_ip))


def test_var_shifts_match_jax():
    rng = np.random.default_rng(3)
    raw = rng.integers(0, 2**32, 16, np.uint64).astype(np.uint32)
    k = rng.integers(0, 5000, 16).astype(np.int32)
    for tf, jf in ((TC.crc32_var_shift, JC.crc32_var_shift),
                   (TC.crc32_var_unshift, JC.crc32_var_unshift)):
        got = tf(torch.from_numpy(raw.astype(np.int64)),
                 torch.from_numpy(k), 5000)
        want = np.asarray(jf(jnp.asarray(raw), jnp.asarray(k), 5000))
        assert np.array_equal(got.numpy(), want.astype(np.int64))
    back = TC.crc32_var_unshift(TC.crc32_var_shift(
        torch.from_numpy(raw.astype(np.int64)), torch.from_numpy(k), 5000),
        torch.from_numpy(k), 5000)
    assert np.array_equal(back.numpy(), raw.astype(np.int64))
    word = torch.from_numpy(raw.astype(np.int64))
    assert [int(x) for x in TC.crc32_raw4_le(word)] == \
        [int(x) for x in np.asarray(JC.crc32_raw4_le(jnp.asarray(raw)))]


def test_idat_crc_matches_zlib_and_jax():
    """Payloads spanning several 4096-byte chunks (odd count: the tree's
    zero-pad branch) with per-image prefixes."""
    rng = np.random.default_rng(5)
    B, NW = 3, 5 * 1024
    words = _words(rng, B, NW)
    prefixes = [b"\x78\x01" + bytes(rng.integers(0, 256, 40, np.uint8))
                for _ in range(B)]
    tbytes = np.array([4097, 3 * 4096 + 1333, NW * 4], np.int64)
    adler = rng.integers(0, 2**32, B, np.uint64).astype(np.uint32)
    plens = np.array([len(p) for p in prefixes], np.int32)
    raw_ip = TA.raw_idat_prefix(prefixes)
    assert np.array_equal(raw_ip, JA.raw_idat_prefix(prefixes))
    got = TA.idat_crc_words(
        torch.from_numpy(words.view(np.int32)),
        torch.from_numpy(tbytes * 8), torch.from_numpy(adler.astype(np.int64)),
        torch.from_numpy(plens), torch.from_numpy(raw_ip.astype(np.int64)))
    want = np.asarray(JA.idat_crc_words(
        jnp.asarray(words), jnp.asarray(tbytes * 8), jnp.asarray(adler),
        jnp.asarray(plens), jnp.asarray(raw_ip), interpret=True))
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    for b in range(B):
        raw = bytearray(words[b].tobytes()[:tbytes[b]])
        raw[:len(prefixes[b])] = prefixes[b]
        msg = b"IDAT" + bytes(raw) + int(adler[b]).to_bytes(4, "big")
        assert int(got[b]) == zlib.crc32(msg), b


def _zlib_idat(words, tbytes, adler, prefixes):
    out = []
    for b in range(len(prefixes)):
        raw = bytearray(words[b].tobytes()[:tbytes[b]])
        raw[:len(prefixes[b])] = prefixes[b]
        msg = b"IDAT" + bytes(raw) + int(adler[b]).to_bytes(4, "big")
        out.append(zlib.crc32(msg))
    return out


# (chunks K, payload end bytes tb per image as a function of N = 4 * NW,
# prefix lengths; None = one prefix object shared by the batch, as 1-pass)
IDAT_CASES = {
    "k49_odd": (49, lambda N: [N - 777, 3 * 4096 + 5, 40 * 4096], None),
    "k1": (1, lambda N: [61, 4096, 2000], [10, 0, 33]),
    "no_tail": (3, lambda N: [N, N, N - 1], [40, 2, 17]),
    "tb_in_first_chunk": (3, lambda N: [4095, 200, 65], [20, 20, 64]),
    "plen0": (2, lambda N: [N - 4, 9, 4097], [0, 0, 0]),
    "per_image_prefixes": (4, lambda N: [N - 2, 2 * 4096, 7000], [300, 5, 1]),
}


def _idat_inputs(case):
    K, tb_of, plens = IDAT_CASES[case]
    rng = np.random.default_rng(K + len(case))
    B, NW = 3, K * 1024
    words = _words(rng, B, NW)
    if plens is None:
        one = bytes(rng.integers(0, 256, 37, np.uint8))
        prefixes = [one] * B
    else:
        prefixes = [bytes(rng.integers(0, 256, n, np.uint8)) for n in plens]
    tbytes = np.array(tb_of(4 * NW), np.int64)
    adler = rng.integers(0, 2**32, B, np.uint64).astype(np.uint32)
    plens = np.array([len(p) for p in prefixes], np.int32)
    return words, tbytes, adler, prefixes, plens, TA.raw_idat_prefix(prefixes)


@pytest.mark.parametrize("case", sorted(IDAT_CASES))
def test_idat_crc_plain_edge_cases_match_jax_and_zlib(case):
    words, tbytes, adler, prefixes, plens, raw_ip = _idat_inputs(case)
    got = TA.idat_crc_words_plain(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(tbytes * 8),
        torch.from_numpy(adler.astype(np.int64)), plens,
        raw_ip.astype(np.int64))
    assert [int(g) for g in got] == _zlib_idat(words, tbytes, adler,
                                               prefixes)
    if words.shape[1] <= 4 * 1024:  # interpret mode grows with K
        want = np.asarray(JA.idat_crc_words(
            jnp.asarray(words), jnp.asarray(tbytes * 8), jnp.asarray(adler),
            jnp.asarray(plens), jnp.asarray(raw_ip), interpret=True))
        assert np.array_equal(got.numpy(), want.astype(np.int64))


def _apply(rows, v):
    """A GF(2) matrix given as 32 basis images applied to one register."""
    acc = 0
    for k in range(32):
        if (v >> k) & 1:
            acc ^= int(rows[k])
    return acc


def _twin_shift(tables, v, k, inverse=False):
    """Kernel B2's shift: one table of the 2^t-byte matrices per set bit of
    k (csrc/crc_words.cu:gf2_shift)."""
    base = TC.SHIFT_LEVELS if inverse else 0
    t = 0
    while k:
        if k & 1:
            v = _apply(tables[base + t], v)
        k >>= 1
        t += 1
    return v


def _twin_count(k, max_k):
    return max(k, 0) & ((1 << max(int(max_k).bit_length(), 1)) - 1)


def _kernel_twin(words, tbytes, adler, plens, raw_ip):
    """numpy twin of fpng_idat_crc: the XOR of the chunk registers, each
    shifted by the 4096 * (K - 1 - c) zero bytes after it, then the finish
    with the same tables."""
    tables = TC._shift_tables()
    B, NW = words.shape
    N, K = 4 * NW, NW // 1024
    regs = TC.crc_chunks_plain(torch.from_numpy(words.view(np.int32)),
                               torch.from_numpy(plens.astype(np.int64)),
                               torch.from_numpy(tbytes)).numpy()
    out = []
    for b in range(B):
        tb, plen = int(tbytes[b]), int(plens[b])
        full = 0
        for c in range(K):
            full ^= _twin_shift(tables, int(regs[b, c]), 4096 * (K - 1 - c))
        stuff = _twin_shift(tables, full, _twin_count(N - tb, N), True)
        a = int(adler[b])
        a_le = int.from_bytes(a.to_bytes(4, "big"), "little")
        raw1 = _apply(tables[2], stuff) ^ _apply(tables[-1], a_le)
        raw_m = _twin_shift(tables, int(raw_ip[b]),
                            _twin_count(tb + 4 - plen, N + 8)) ^ raw1
        init = _twin_shift(tables, 0xFFFFFFFF, _twin_count(tb + 8, N + 8))
        out.append(raw_m ^ init ^ 0xFFFFFFFF)
    return out


@pytest.mark.parametrize("k", [0, 1, 4, 4096, 49 * 4096, 123457, 2**31 - 3])
def test_twin_shift_matches_shift_matrix(k):
    tables = TC._shift_tables()
    rng = np.random.default_rng(k)
    for v in rng.integers(0, 2**32, 4, np.uint64):
        v = int(v)
        fwd = _twin_shift(tables, v, k)
        assert fwd == _apply(TC._shift_matrix(k), v)
        assert _twin_shift(tables, fwd, k, inverse=True) == v


@pytest.mark.parametrize("case", sorted(IDAT_CASES))
def test_kernel_twin_matches_plain_and_zlib(case):
    words, tbytes, adler, prefixes, plens, raw_ip = _idat_inputs(case)
    want = _zlib_idat(words, tbytes, adler, prefixes)
    assert _kernel_twin(words, tbytes, adler, plens, raw_ip) == want


def test_devcrc_assembly_equals_build_png():
    """launch_assemble + _finish_batch_devcrc against container.build_png
    on payloads reaching the buffer edge, with per-image prefixes."""
    from fpng_tpu.container import build_png
    from fpng_tpu_torch.models.encoder import (_finish_batch_devcrc,
                                               launch_assemble)

    rng = np.random.default_rng(3)
    B, W, H, Cc = 6, 9, 7, 3
    NW = 1024
    words = _words(rng, B, NW)
    prefixes = [bytes(rng.integers(0, 256, rng.integers(5, 60), np.uint8))
                for _ in range(B)]
    tbytes = np.array([61, 200, NW * 4 - 20, 100, NW * 4 - 18, NW * 4])
    adler = rng.integers(0, 2**32, B, np.uint64).astype(np.int64)
    tw = torch.from_numpy(words.view(np.int32))
    total_bits = torch.from_numpy(tbytes * 8)
    crc = launch_assemble(tw, total_bits, torch.from_numpy(adler), prefixes)
    budget = NW * 4
    pngs = _finish_batch_devcrc(  # on the results as read back to the host
        np.zeros((B, H, W, Cc), np.uint8), tw.numpy(), crc.numpy(),
        total_bits.numpy(), np.full(B, -1), adler, prefixes, budget)
    for b in range(B):
        if tbytes[b] + 4 > budget:  # the stored fallback fired
            assert (pngs[b][58 + 2] & 6) == 0
            continue
        raw = bytearray(words[b].tobytes()[:tbytes[b]])
        raw[:len(prefixes[b])] = prefixes[b]
        z = bytes(raw) + int(adler[b]).to_bytes(4, "big")
        assert pngs[b] == build_png(z, W, H, Cc), b
