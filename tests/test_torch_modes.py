"""fpng_tpu_torch's encode modes against fpng_tpu's, on the CPU.

The 32 bpp 1-pass cost check (kernel B7's plain version, and build_desc
with it), the 2-pass histogram, and the PNG bytes of encode_batch in all
four modes (3/4 channels x 1-pass/2-pass) on the conftest shapes; for
2-pass the bytes must also equal golden's.  Inputs come from seeded numpy;
tolerance zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fpng_tpu as F
import fpng_tpu_torch as T
from fpng_tpu.models import encoder as JE
from fpng_tpu.ops import encfuse as JF
from fpng_tpu.ops.filter import filter_deltas as jfilter
from fpng_tpu.ops.tokenize import match_fields as jmatch
from fpng_tpu.tables import get_one_pass_tables
from fpng_tpu_torch import golden
from fpng_tpu_torch.models import encoder as TE
from fpng_tpu_torch.ops.encfuse import demote_mask, demote_mask_plain
from tests.conftest import make_test_image

SHAPES = [(1, 1), (1, 7), (7, 1), (2, 2), (13, 17), (16, 16), (33, 7),
          (64, 64), (40, 100), (3, 300), (127, 31)]
KINDS = ("mixed", "flat", "noise")
_jax_build_desc = jax.jit(
    JE.build_desc,
    static_argnames=("num_chans", "cost_check", "force_xla_demote"))


def _batch(h, w, c, seed):
    rng = np.random.default_rng(seed)
    return np.stack([make_test_image(rng, h, w, c, k) for k in KINDS])


def _few_colours(B, h, w, seed):
    """4-channel images over a 2-value alphabet: many 1-pixel matches."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2, (B, h, w, 4)) * 37).astype(np.uint8)


def _tables(B, c, seed):
    """(codes, sizes) (B, 288): the 1-pass tables for image 0, the 2-pass
    tables of random histograms for the others (varied code sizes), and
    for image 2 sizes that make every 1-pixel match (length 4, symbol 258,
    no extra bits) cost exactly its four literals: 7 + 1 = 4 x 2, a tie
    that fpng's strict > keeps as a match."""
    rng = np.random.default_rng(seed)
    _, _, _, codes1, sizes1 = get_one_pass_tables(c)
    hist = rng.integers(0, 1000, (B, 288)).astype(np.uint32)
    hist[:, 286:] = 0
    codes, sizes, *_ = TE._build_tables_python(hist, c)
    codes[0], sizes[0] = codes1, sizes1
    if B > 2:
        sizes[2] = 2
        sizes[2, 258] = 7
    return codes.astype(np.int64), sizes.astype(np.int64)


def _demote_inputs(imgs, codes, sizes):
    B, H, W, Cc = imgs.shape
    deltas = jfilter(jnp.asarray(imgs))
    _, mstart, mlen = jmatch(deltas, Cc)
    adj = jnp.where(mstart, mlen * Cc - 3, 0)
    len_sym, len_extra = JE._len_sym_extra(adj)
    tbl = JF.pack_table(jnp.asarray(codes.astype(np.uint32)),
                        jnp.asarray(sizes.astype(np.int32)))
    return tuple(np.array(a) for a in (
        deltas, len_sym, len_extra, mstart & (mlen == 1), tbl))


@pytest.mark.parametrize("h,w", [(13, 17), (64, 70), (100, 100)])
def test_demote_plain_matches_jax(h, w):
    """B7's plain version against demote_mask_tpu (interpret mode) and
    against fpng_tpu's XLA formula, on images with 1-pixel match starts;
    100 x 100 spans two of the Pallas kernel's pixel tiles."""
    imgs = _few_colours(3, h, w, h * w)
    codes, sizes = _tables(3, 4, h + w)
    deltas, ls, le, cand, tbl = _demote_inputs(imgs, codes, sizes)
    want = np.asarray(JF.demote_mask_tpu(
        jnp.asarray(deltas), jnp.asarray(ls), jnp.asarray(le),
        jnp.asarray(cand), jnp.asarray(tbl), interpret=True))
    lit_sz = np.take_along_axis(sizes, deltas.reshape(3, -1).astype(np.int64),
                                axis=1).reshape(deltas.shape)
    msz = np.take_along_axis(sizes, ls.reshape(3, -1).astype(np.int64),
                             axis=1).reshape(ls.shape)
    cost = msz + le + 1 - lit_sz.sum(axis=-1)
    xla = cand & (cost > 0)
    got = demote_mask(*(torch.from_numpy(a) for a in (deltas, ls, le, cand,
                                                      tbl))).numpy()
    assert np.array_equal(want, xla) and np.array_equal(got, want)
    # both outcomes occur, and ties (image 2) stay matches
    assert got.any() and (cand & ~got).any()
    assert (cand[2] & (cost[2] == 0)).any() and not got[2].any()


def test_demote_plain_reads_len_sym_only_at_candidates():
    imgs = _few_colours(2, 9, 11, 5)
    codes, sizes = _tables(2, 4, 6)
    deltas, ls, le, cand, tbl = _demote_inputs(imgs, codes, sizes)
    garbage = np.where(cand, ls, 1 << 20).astype(np.int32)
    args = [torch.from_numpy(a) for a in (deltas, ls, le, cand, tbl)]
    want = demote_mask_plain(*args)
    args[1] = torch.from_numpy(garbage)
    assert torch.equal(demote_mask_plain(*args), want)


@pytest.mark.parametrize("h,w", SHAPES)
def test_build_desc_cost_check_matches_jax(h, w):
    """build_desc with the 32 bpp cost check against fpng_tpu's with its
    XLA formula (force_xla_demote), on every unit of the desc stream."""
    imgs = _batch(h, w, 4, 7 * h + w)
    imgs[1:] = _few_colours(2, h, w, h)
    codes, sizes = _tables(3, 4, h)
    pv = np.array([3, 0, 5], np.int32)
    pn = np.array([3, 0, 7], np.int32)
    jd, jt, *_ = _jax_build_desc(
        jnp.asarray(imgs), jnp.asarray(codes.astype(np.uint32)),
        jnp.asarray(sizes.astype(np.int32)), jnp.asarray(pv), jnp.asarray(pn),
        num_chans=4, cost_check=True, force_xla_demote=True)
    td, tt, *_ = TE.build_desc(
        torch.from_numpy(imgs), torch.from_numpy(codes),
        torch.from_numpy(sizes), torch.from_numpy(pv), torch.from_numpy(pn),
        num_chans=4, cost_check=True)
    assert np.array_equal(np.asarray(jd), td.numpy())
    assert np.array_equal(np.asarray(jt), tt.numpy())


@pytest.mark.parametrize("c,h,w", [(3, 13, 17), (3, 127, 31), (4, 1, 1),
                                   (4, 64, 64), (4, 3, 300)])
def test_hist_kernel_matches_jax(c, h, w):
    imgs = _batch(h, w, c, 11 * h + w)
    want = np.asarray(JE.hist_kernel(jnp.asarray(imgs), num_chans=c))
    got = TE.hist_kernel(torch.from_numpy(imgs), num_chans=c)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)
    assert (got.sum(dim=1) > 0).all()


MODES = [(3, 0), (3, F.FPNG_ENCODE_SLOWER), (4, 0), (4, F.FPNG_ENCODE_SLOWER)]


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("c,flags", MODES,
                         ids=["rgb_1pass", "rgb_2pass", "rgba_1pass",
                              "rgba_2pass"])
def test_encode_batch_bytes_match_every_mode(c, flags, h, w):
    """Byte-identical PNGs in every mode (noise images take the stored
    fallback), equal to golden's for 2-pass, that round-trip through the
    port's decoder."""
    imgs = _batch(h, w, c, 131 * h + w + c)
    got = T.encode_batch(imgs, flags, device="cpu")
    assert got == F.encode_batch(imgs, flags)
    if flags & F.FPNG_ENCODE_SLOWER:
        assert got == [golden.encode_image_to_memory(i, w, h, c, flags)
                       for i in imgs]
    sts, outs = T.decode_batch(got, c, device="cpu")
    assert sts == [0, 0, 0]
    assert all(np.array_equal(o, i) for o, i in zip(outs, imgs))
