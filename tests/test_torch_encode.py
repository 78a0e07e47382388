"""fpng_tpu_torch's encoder against fpng_tpu's, on the CPU, bit-exact.

The same numpy inputs go through the JAX function and the port's plain
torch version; every quantity is an integer, a word or a byte, so the
tolerance is zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpng_tpu import constants as C
from fpng_tpu.models import encoder as JE
from fpng_tpu.ops import bitpack as JB
from fpng_tpu.ops import encfuse as JF
from fpng_tpu.tables import get_one_pass_tables
from fpng_tpu_torch.models import encoder as TE
from fpng_tpu_torch.ops.encfuse import encode_bits_fused, encode_bits_plain
from fpng_tpu_torch.ops.filter import filter_deltas
from fpng_tpu_torch.ops.tokenize import match_fields
from tests.conftest import make_test_image

SHAPES = [(1, 1), (1, 7), (7, 1), (2, 2), (13, 17), (16, 16), (33, 7),
          (64, 64), (40, 100), (3, 300), (127, 31)]
KINDS = ("mixed", "flat", "noise")
# one compiled program per shape instead of one per op
_jax_build_desc = jax.jit(JE.build_desc,
                          static_argnames=("num_chans", "cost_check"))


def _batch(h, w, seed):
    rng = np.random.default_rng(seed)
    return np.stack([make_test_image(rng, h, w, 3, k) for k in KINDS])


def _tables(B):
    prefix, acc, nacc, codes1, sizes1 = get_one_pass_tables(3)
    codes = np.broadcast_to(codes1.astype(np.int64), (B, 288)).copy()
    sizes = np.broadcast_to(sizes1.astype(np.int64), (B, 288)).copy()
    base = np.full(B, len(prefix) * 8, np.int32)
    pv = np.full(B, acc, np.int32)
    pn = np.full(B, nacc, np.int32)
    return codes, sizes, base, pv, pn


def _descs(imgs):
    codes, sizes, base, pv, pn = _tables(imgs.shape[0])
    jd, jt, *_ = _jax_build_desc(
        jnp.asarray(imgs), jnp.asarray(codes.astype(np.uint32)),
        jnp.asarray(sizes.astype(np.int32)), jnp.asarray(pv),
        jnp.asarray(pn), num_chans=3, cost_check=False)
    td, tt, *_ = TE.build_desc(
        torch.from_numpy(imgs), torch.from_numpy(codes),
        torch.from_numpy(sizes), torch.from_numpy(pv), torch.from_numpy(pn),
        num_chans=3, cost_check=False)
    return (jd, jt), (td, tt), (codes, sizes, base)


def test_len_sym_extra_matches():
    adj = np.arange(256, dtype=np.int32).reshape(1, 16, 16)
    js, je = JE._len_sym_extra(jnp.asarray(adj))
    ts, te = TE._len_sym_extra(torch.from_numpy(adj))
    assert np.array_equal(np.asarray(js), ts.numpy())
    assert np.array_equal(np.asarray(je), te.numpy())
    assert np.array_equal(ts.numpy().ravel(), C.LEN_SYM)


@pytest.mark.parametrize("h,w", SHAPES)
def test_build_desc_matches(h, w):
    imgs = _batch(h, w, h * 1000 + w)
    (jd, jt), (td, tt), _ = _descs(imgs)
    assert td.dtype == torch.int32
    assert np.array_equal(np.asarray(jd), td.numpy())
    assert np.array_equal(np.asarray(jt), tt.numpy())


def test_filter_and_match_fields_match():
    from fpng_tpu.ops.filter import filter_deltas as jfilter
    from fpng_tpu.ops.tokenize import match_fields as jmatch

    imgs = _batch(40, 100, 1)
    jd = jfilter(jnp.asarray(imgs))
    td = filter_deltas(torch.from_numpy(imgs))
    assert np.array_equal(np.asarray(jd), td.numpy())
    for a, b in zip(jmatch(jd, 3), match_fields(td, 3)):
        assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("h,w,interpret", [
    (13, 29, True), (64, 64, False), (127, 31, False)])
def test_b1_plain_matches_jax(h, w, interpret):
    """The port's plain B1 chain equals the JAX XLA path on every word,
    and the fused Pallas kernel (interpret mode) up to total_bits."""
    imgs = _batch(h, w, 7 * h + w)
    (jd, jt), (td, tt), (codes, sizes, base) = _descs(imgs)
    num_words = TE._num_words(TE._budget(h, w, 3))

    vals, nbits, ts = JF.materialize_units(
        jd, jnp.asarray(codes.astype(np.uint32)),
        jnp.asarray(sizes.astype(np.int32)))
    offsets = JB.exclusive_offsets(nbits, jnp.asarray(base))
    x_words = np.asarray(JB.scatter_bits(vals, nbits, offsets, num_words))
    x_total = np.asarray(offsets[:, -1] + nbits[:, -1])
    x_ltok = np.asarray(jnp.max(jnp.where(ts, offsets, -1), axis=1))
    words, total, ltok = encode_bits_fused(td, tt, torch.from_numpy(base),
                                           num_words)
    words = words.numpy().view(np.uint32)
    assert np.array_equal(words, x_words)
    assert np.array_equal(total.numpy(), x_total)
    assert np.array_equal(ltok.numpy(), x_ltok)
    if not interpret:
        return
    f_words, f_total, f_ltok = (np.asarray(a) for a in JF.encode_bits_fused(
        jd, jt, jnp.asarray(base), num_words, interpret=True))
    assert np.array_equal(total.numpy(), f_total)
    assert np.array_equal(ltok.numpy(), f_ltok)
    for b in range(imgs.shape[0]):
        nw = (int(f_total[b]) + 31) // 32
        assert np.array_equal(words[b, :nw], f_words[b, :nw]), b


def test_b1_plain_drops_words_past_the_buffer():
    imgs = _batch(16, 16, 3)
    _, (td, tt), (_, _, base) = _descs(imgs)
    full, total, _ = encode_bits_plain(td, tt, torch.from_numpy(base), 1024)
    cut, total2, _ = encode_bits_plain(td, tt, torch.from_numpy(base), 40)
    assert torch.equal(cut, full[:, :40]) and torch.equal(total, total2)


def test_b1_plain_saturates_totals_past_int32():
    """Bit offsets are int64, and so are total_bits and last_tok, as kernel
    B1's outputs: a stream past 2^31 bits keeps its exact counts, no longer
    saturated at 2^31 - 1."""
    imgs = _batch(16, 16, 3)
    _, (td, tt), (_, _, base) = _descs(imgs)
    words, total, last = encode_bits_plain(td, tt, torch.from_numpy(base), 64)
    near = torch.full_like(torch.from_numpy(base), 2 ** 31 - 100)
    w2, t2, l2 = encode_bits_plain(td, tt, near, 64)
    assert t2.dtype == l2.dtype == torch.int64
    shift = 2 ** 31 - 100 - torch.from_numpy(base).to(torch.int64)
    assert torch.equal(t2, total + shift) and torch.equal(l2, last + shift)
    assert (t2 > 2 ** 31 - 1).all() and (l2 > 2 ** 31 - 1).all()
    assert not w2.any()  # every unit lands past the 64 words
    assert (total < 2 ** 31 - 1).all() and (last < total).all()
