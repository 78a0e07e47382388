"""fpng_tpu_torch's PK=1 decode against fpng_tpu's, on the CPU.

The input is a batch of 32 x 32 x 4 2-pass tiles, the first of which needs
more than walk8's 96 step rows in a chunk.  The same packed streams go
through fpng_tpu's PK=1 kernels in interpret mode - walk_fix_tpu (called
directly with lpi = 128, its smallest lane group, instead of
_decode_walk's 512) and _finalize_records - and through the port's plain
versions of B8 and B9; tolerance zero.  Walk records may differ in which
steps a lane recorded before it converged, so they are compared through
what they decide: converged entries, output offsets, steps, the per-image
check triple, the literal raster, pixels and ok flags.

The Pallas finalize's interpret-mode compile grows steeply with its row
count, so it runs on 16-row slices of the records, each with its entry
carry computed from the records (as tests/test_torch_walk8.py does).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fpng_tpu_torch as T
from fpng_tpu.ops import specdec_tpu as JS
from fpng_tpu.ops.bitpack import scatter_packed16_tpu
from fpng_tpu_torch import golden
from fpng_tpu_torch.models import decoder as TD
from fpng_tpu_torch.ops import specdec_tpu as TS
from fpng_tpu_torch.ops import walk8 as TW
from fpng_tpu_torch.ops.bitpack import scatter_packed16
from fpng_tpu_torch.train import synthetic_corpus
from fpng_tpu_torch.utils import trace
from tests.test_torch_walk8 import _jacobi_reference, _pack, _walk_args

LPI = 128
PIECE = 16
_finalize_piece = jax.jit(
    functools.partial(JS._finalize_records, k8=PIECE, interpret=True,
                      wide=True),
    static_argnames=("geom", "ncg"))


def _jax_chain(stream, luts, p0, zl, *, h, w, c):
    B = stream.shape[0]
    nc = TW.n_chunks(int(zl.max()))
    nc_pad = -(-nc // LPI) * LPI
    w24, ng = JS._prep_w24_tiles(jnp.asarray(stream), nc_pad, LPI)
    e_fin, posr, raw0, raw1, nst4 = JS.walk_fix_tpu(
        w24, jnp.asarray(luts.view(np.int32)).reshape(B, 4, 8, 128),
        jnp.asarray(p0), jnp.asarray((zl * 8).reshape(B, 1)), ng=ng,
        lpi=LPI, interpret=True)

    # _decode_walk's epilogue, on (B, ST8, NC) lane-major copies
    def lanes(a):
        return np.asarray(a).transpose(0, 2, 1, 3).reshape(B, JS.ST8, nc_pad)

    p, r0, r1 = lanes(posr), lanes(raw0), lanes(raw1)
    e = np.asarray(e_fin).reshape(B, nc_pad)
    nst = np.asarray(nst4).reshape(B, nc_pad)
    live = np.arange(nc_pad)[None] * 512 < zl[:, None] * 8
    rows = np.arange(JS.ST8)[None, :, None]
    recb = (((r0 >> 9) & 1) == 1) & live[:, None] & (rows < nst[:, None])
    validr = recb & (p >= e[:, None])
    dem = recb & (r1 != 0) & (p < e[:, None]) & \
        (p + ((r0 >> 19) & 15) == e[:, None])
    outl = (r0 >> 10) & 511
    outb = np.where(live, (validr * outl + dem * (outl - 1)).sum(axis=1), 0)
    out0 = np.cumsum(outb, axis=1) - outb
    steps = int(((validr | dem) * (rows + 1)).max())
    res = dict(e_fin=e, out0=out0, steps=steps, live=live)

    # _finalize_records on 16-row slices; each slice's entry carry is out0
    # plus the bytes of the rows before it
    ol = np.where(validr | dem, np.where(dem, 1, outl), 0)
    carry = out0[:, None, :] + np.cumsum(ol, axis=1) - ol
    rs, bpl = 1 + w * c, w * c
    bpl_pad = JS._bpl_pad(bpl)
    metas, metbs, chks = [], [], []
    for k in range(-(-steps // PIECE)):
        sl = slice(PIECE * k, PIECE * (k + 1))
        meta, metb, chk = _finalize_piece(
            posr[:, :, sl], raw0[:, :, sl], raw1[:, :, sl],
            jnp.maximum(nst4 - PIECE * k, 0), e_fin.reshape(B, nc_pad),
            jnp.asarray(carry[:, PIECE * k].astype(np.int32)),
            geom=(rs, h * rs, c, bpl_pad), ncg=ng)
        metas.append(np.asarray(meta).reshape(B, nc_pad, PIECE))
        metbs.append(np.asarray(metb).reshape(B, nc_pad, PIECE))
        chks.append(np.asarray(chk))
    chk = np.concatenate(chks, axis=1)  # (B, groups x slices, 3)
    res["chk"] = np.stack([chk[:, :, 0].any(axis=1), chk[:, :, 1].min(axis=1),
                           chk[:, :, 2].min(axis=1)], axis=1)
    H8 = -(-h // 8) * 8
    dep = scatter_packed16_tpu(
        jnp.asarray(np.concatenate(metas, axis=2).reshape(B, -1)),
        H8 * (bpl_pad // 2),
        metb=jnp.asarray(np.concatenate(metbs, axis=2).reshape(B, -1)),
        interpret=True, wide=True)
    res["raster"] = np.asarray(dep).view(np.uint16) \
        .reshape(B, H8, bpl_pad)[:, :h, :bpl]
    res["imgs"] = np.asarray(JS.expand_tpu(
        jax.lax.bitcast_convert_type(dep, jnp.int32), h=h, w=w, c=c,
        bpl_pad=bpl_pad, interpret=True))
    fail, eob, bad = res["chk"].T.astype(np.int64)
    res["ok"] = (fail == 0) & (eob != JS._INF) & (eob <= bad) & \
        (((eob + 7) >> 3) == zl - 4)
    return res


def _port_chain(stream, luts, p0, zl, *, h, w, c):
    B = stream.shape[0]
    args = (torch.from_numpy(stream), torch.from_numpy(luts.astype(np.int64)),
            torch.from_numpy(p0), torch.from_numpy(zl))
    nc = TW.n_chunks(int(zl.max()))
    records, e_fin, out0, steps, _, passes = TW.walk_offsets(
        TS.walk_fix, *args, n_chunks=nc)
    k8 = TW.trim_steps(int(steps), TS.ST8)
    meta, metb, chk = TS.finalize_records(*records, e_fin, out0, k8=k8, h=h,
                                          bpl=w * c, c=c)
    raster = scatter_packed16(meta.reshape(B, -1), metb.reshape(B, -1),
                              h * w * c)
    imgs, ok = TS.decode_kernel_pk1(*args, h=h, w=w, c=c,
                                    zlib_len_max=int(zl.max()))
    return dict(e_fin=e_fin.numpy(), out0=out0.numpy(), steps=int(steps),
                nc=nc, passes=passes, chk=chk.numpy(),
                raster=raster.numpy().view(np.uint16).reshape(B, h, w * c),
                imgs=imgs.numpy(), ok=ok.numpy())


@pytest.fixture(scope="module")
def chains():
    tiles = list(synthetic_corpus(4, size=32))
    imgs = np.stack([tiles[6], tiles[9]])
    pngs = [golden.encode_image_to_memory(i, 32, 32, 4, T.FPNG_ENCODE_SLOWER)
            for i in imgs]
    packed = _pack(pngs)
    return imgs, pngs, packed, _jax_chain(*packed, h=32, w=32, c=4), \
        _port_chain(*packed, h=32, w=32, c=4)


def test_input_overflows_walk8(chains):
    _, _, packed, _, t = chains
    ovf = TW.decode_walk8(*(torch.from_numpy(a) for a in packed),
                          n_chunks=t["nc"])[4]
    assert ovf.tolist() == [True, False]
    assert 96 < t["steps"] <= TS.ST8


def test_entries_offsets_and_steps_match_jax(chains):
    _, _, _, j, t = chains
    assert t["nc"] > 1 and t["passes"] > 1  # a real cross-chunk fixpoint
    live = j["live"][:, :t["nc"]]
    for key in ("e_fin", "out0"):
        assert np.array_equal(np.where(live, t[key], 0),
                              np.where(live, j[key][:, :t["nc"]], 0)), key
    assert t["steps"] == j["steps"]


def test_check_triple_matches_jax(chains):
    _, _, _, j, t = chains
    assert np.array_equal(t["chk"].astype(np.int64),
                          j["chk"].astype(np.int64))
    assert (t["chk"][:, 0] == 0).all()


def test_deposit_raster_matches_jax(chains):
    _, _, _, j, t = chains
    assert np.array_equal(t["raster"], j["raster"])


def test_pixels_and_ok_match_jax(chains):
    imgs, _, _, j, t = chains
    assert np.array_equal(t["ok"], j["ok"]) and t["ok"].all()
    assert np.array_equal(t["imgs"], j["imgs"])
    assert np.array_equal(t["imgs"], imgs)


@pytest.mark.parametrize("walk8", ["1", "0"])
def test_decode_batch_takes_pk1(chains, walk8, monkeypatch):
    """Through the public API: walk8 overflows and PK=1 decodes the batch
    on the device path, or FPNG_TPU_WALK8=0 goes to PK=1 straight away."""
    monkeypatch.setenv("FPNG_TPU_WALK8", walk8)
    imgs, pngs, *_ = chains
    n0, k0 = TD.decode_batch.walk8_overflows, TD.decode_batch.paths["pk1"]
    h0 = TD.decode_batch.host_handoffs
    sts, outs = T.decode_batch(pngs, 4, device="cpu")
    assert sts == [0, 0]
    assert all(np.array_equal(o, i) for o, i in zip(outs, imgs))
    assert TD.decode_batch.walk8_overflows == n0 + (walk8 == "1")
    assert TD.decode_batch.paths["pk1"] == k0 + 1
    assert TD.decode_batch.host_handoffs == h0


def test_pk1_plain_walk_runs_every_image_to_convergence(chains):
    """B8's plain walk runs every image to convergence: on the batch whose
    image 0 overflows walk8 it gives the Jacobi loop's outputs and pass
    count at ST8 rows, for both images."""
    _, _, packed, _, t = chains
    words, lut, p0, zl8, nc = _walk_args(packed)
    got = TS.walk_fix(words, lut, p0, zl8, n_chunks=nc)
    ref = _jacobi_reference(words, lut, p0, zl8, n_chunks=nc, ST=TS.ST8)
    assert int(got[6]) == ref[6] == int(t["passes"])
    for a, b in zip(got[:6], ref[:6]):
        assert torch.equal(a, b)


def test_pk1_resumed_from_walk8_entries_matches_the_unseeded_walk(chains):
    """B8 seeded with B3's converged entries (what decode_kernel8 returns
    on this batch's overflow) reads 2 passes to the unseeded walk's
    entries and offsets, and finish_decode gives the same check triple and
    pixels - the port's unseeded chain's and fpng_tpu's."""
    imgs, _, packed, j, t = chains
    args = [torch.from_numpy(a) for a in packed]
    imgs8, ok8, seed = TW.decode_kernel8(*args, h=32, w=32, c=4,
                                         zlib_len_max=int(packed[3].max()))
    assert imgs8 is None and ok8 is None and seed.dtype == torch.int32
    records, e_fin, out0, steps, _, passes = TW.walk_offsets(
        functools.partial(TS.walk_fix, seed=seed), *args, n_chunks=t["nc"])
    assert int(passes) == 2 < int(t["passes"])
    assert np.array_equal(e_fin.numpy(), t["e_fin"])
    assert np.array_equal(out0.numpy(), t["out0"])
    live = j["live"][:, :t["nc"]]
    for key, got in (("e_fin", e_fin), ("out0", out0)):
        assert np.array_equal(np.where(live, got.numpy(), 0),
                              np.where(live, j[key][:, :t["nc"]], 0)), key
    k8 = TW.trim_steps(int(steps), TS.ST8)
    assert 8 * TW.MAXIT < k8 <= TW.trim_steps(t["steps"], TS.ST8)
    _, _, chk = TS.finalize_records(*records, e_fin, out0, k8=k8, h=32,
                                    bpl=128, c=4)
    assert np.array_equal(chk.numpy(), t["chk"])
    assert np.array_equal(chk.numpy().astype(np.int64),
                          j["chk"].astype(np.int64))
    got, ok = TW.finish_decode(TS.finalize_records, records, e_fin, out0,
                               args[3], k8=k8, h=32, w=32, c=4)
    assert bool(ok.all()) and np.array_equal(got.numpy(), imgs)
    assert np.array_equal(ok.numpy(), j["ok"])
    assert np.array_equal(got.numpy(), j["imgs"])


@pytest.mark.parametrize("walk8", ["1", "0"])
def test_decode_batch_resumes_pk1_from_walk8(chains, walk8, monkeypatch):
    """A traced decode_batch: after walk8's overflow the PK=1 walk resumes
    from walk8's entries (decoder.pk1_resumed 1, 2 passes); with
    FPNG_TPU_WALK8=0 it starts from the chunk boundaries, unseeded, in the
    unseeded walk's passes.  The pixels are the input's either way."""
    monkeypatch.setenv("FPNG_TPU_WALK8", walk8)
    monkeypatch.setattr(TD.decode_batch, "spans", {})  # traced
    imgs, pngs, _, _, t = chains
    trace.reset()
    try:
        sts, outs = T.decode_batch(pngs, 4, device="cpu")
        cnt = trace.snapshot()["counters"]
    finally:
        trace.reset()
    assert sts == [0, 0]
    assert all(np.array_equal(o, i) for o, i in zip(outs, imgs))
    assert cnt["decoder.pk1_walks"] == 1
    if walk8 == "1":
        assert cnt["decoder.pk1_resumed"] == 1
        assert cnt["decoder.pk1_passes"] == 2
        # B3 walked the whole fixpoint: the unseeded PK=1 walk's passes
        assert cnt["decoder.walk8_walks"] == 1
        assert cnt["decoder.walk8_passes"] == int(t["passes"])
    else:
        assert "decoder.pk1_resumed" not in cnt
        assert "decoder.walk8_walks" not in cnt
        assert cnt["decoder.pk1_passes"] == int(t["passes"]) > 2
