"""fpng_tpu_torch's checksums against fpng_tpu's and zlib, on the CPU.

adler32_bytes, the plain B2 chunk reduction with its combine tree, the
GF(2) register shifts and the IDAT CRC assembly must equal the JAX
functions (Pallas kernels in interpret mode) and zlib bit for bit.
"""

import zlib

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
    # the wrapper of kernel B2 on a CPU tensor is its plain version
    assert torch.equal(TC.crc_chunks(tw, torch.from_numpy(lo),
                                     torch.from_numpy(hi)),
                       TC.crc_chunks_plain(tw, torch.from_numpy(lo),
                                           torch.from_numpy(hi)))


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
    pngs = _finish_batch_devcrc(
        np.zeros((B, H, W, Cc), np.uint8), tw, crc, total_bits,
        torch.full((B,), -1), torch.from_numpy(adler), prefixes, budget)
    for b in range(B):
        if tbytes[b] + 4 > budget:  # the stored fallback fired
            assert (pngs[b][58 + 2] & 6) == 0
            continue
        raw = bytearray(words[b].tobytes()[:tbytes[b]])
        raw[:len(prefixes[b])] = prefixes[b]
        z = bytes(raw) + int(adler[b]).to_bytes(4, "big")
        assert pngs[b] == build_png(z, W, H, Cc), b
