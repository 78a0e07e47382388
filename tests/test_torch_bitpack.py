"""fpng_tpu_torch's bit packing against fpng_tpu's, on the CPU.

The plain deposit (scatter_bits, which deposit_bits runs for CPU tensors)
must equal the JAX scatter on every word, and the Pallas deposit kernel B10
(scatter_bits_tpu, interpret mode, zero_init) on decode-style record
streams with gaps and zero-width units.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpng_tpu.ops import bitpack as JB
from fpng_tpu_torch.ops import bitpack as TB


def test_word32_roundtrip():
    x = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**32 - 1], dtype=torch.int64)
    w = TB.to_word32(x)
    assert w.dtype == torch.int32
    assert np.array_equal(w.numpy().view(np.uint32), x.numpy())
    assert torch.equal(TB.from_word32(w), x)


@pytest.mark.parametrize("seed,n", [(0, 37), (1, 1024), (2, 5000),
                                    (3, 20000)])
def test_scatter_bits_matches_jax(seed, n):
    rng = np.random.default_rng(seed)
    B = 3
    nbits = rng.integers(0, 19, (B, n)).astype(np.int32)
    nbits[:, rng.integers(0, n, n // 4)] = 0
    nbits[:, : n // 8] = 1
    vals = (rng.integers(0, 1 << 31, (B, n)).astype(np.uint32)
            & ((1 << nbits.astype(np.uint32)) - 1))
    base = rng.integers(8, 1200, B).astype(np.int32)
    j_offs = JB.exclusive_offsets(jnp.asarray(nbits), jnp.asarray(base))
    t_offs = TB.exclusive_offsets(torch.from_numpy(nbits),
                                  torch.from_numpy(base))
    assert np.array_equal(np.asarray(j_offs), t_offs.numpy())
    total = t_offs[:, -1] + torch.from_numpy(nbits)[:, -1]
    # one word short of the stream end: the last words are dropped
    num_words = int((total.max() + 31) // 32) - 1
    want = np.asarray(JB.scatter_bits(jnp.asarray(vals), jnp.asarray(nbits),
                                      j_offs, num_words))
    got = TB.deposit_bits(torch.from_numpy(vals.view(np.int32)),
                          torch.from_numpy(nbits), t_offs, num_words)
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_deposit_matches_pallas_with_gaps():
    """Decode-style records: sorted slots with large gaps, zero-width
    duplicates and trailing sentinels; gap words read as zero."""
    rng = np.random.default_rng(7)
    B, n, total = 2, 6000, 50000
    outp = np.sort(rng.integers(0, total, (B, n)))
    lit = rng.random((B, n)) < 0.4
    sym = rng.integers(0, 256, (B, n))
    vals = np.where(lit, sym | 0x100, 0).astype(np.uint32)
    nbits = np.where(lit, 16, 0).astype(np.int32)
    for b in range(B):  # literal slots are distinct
        _, first = np.unique(outp[b], return_index=True)
        dup = np.ones(n, bool)
        dup[first] = False
        vals[b, dup] = 0
        nbits[b, dup] = 0
    offs = (outp * 16).astype(np.int32)
    nw = (16 * (total + 1)) // 32 + 2
    want = np.asarray(JB.scatter_bits_tpu(
        jnp.asarray(vals), jnp.asarray(nbits), jnp.asarray(offs), nw,
        interpret=True, zero_init=True))
    got = TB.deposit_bits(torch.from_numpy(vals.view(np.int32)),
                          torch.from_numpy(nbits), torch.from_numpy(offs), nw)
    assert np.array_equal(got.numpy().view(np.uint32), want)
