"""fpng_tpu_torch's walk8 decode against fpng_tpu's, on the CPU.

The same packed streams go through fpng_tpu.ops.walk8 (Pallas in interpret
mode, lpi=8) and through the port's plain versions of B3-B6; tolerance
zero.  Walk records differ in layout and may differ in which steps a lane
recorded before it converged, so they are compared only through what they
deposit: converged entries, output offsets, overflow flags, the literal
raster, pixels and ok flags.

The Pallas finalize's interpret-mode compile grows steeply with its row
count k8 (tens of seconds at the k8 these streams need), so the JAX chain
runs it on 16-row slices of the records: the same kernel on the same rows,
with each slice's entry carry (the lane's output offset after the rows
before it) computed from the records as the kernel computes it.  Each JAX
chain runs once per module.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fpng_tpu_torch as T
from fpng_tpu.ops import walk8 as JW
from fpng_tpu.ops.bitpack import scatter_packed16_tpu
from fpng_tpu.ops.specdec_tpu import _bpl_pad, expand_tpu
from fpng_tpu_torch import golden
from fpng_tpu_torch.models import decoder as TD
from fpng_tpu_torch.ops import specdec_tpu as TS
from fpng_tpu_torch.ops import walk8 as TW
from fpng_tpu_torch.train import synthetic_corpus

LPI = 8
PIECE = 16
# one compile per (geometry, shapes), shared by every slice
_finalize_piece = jax.jit(
    functools.partial(JW._finalize_records8, k8=PIECE, lpi=LPI,
                      interpret=True, wide=True),
    static_argnames=("geom", "ncg"))


def _pack(pngs):
    metas = [TD._parse_one(p) for p in pngs]
    assert all(m[7] is not None for m in metas)
    stream, luts, p0, zl = TD.pack_streams(metas)
    return stream, luts, p0.astype(np.int32), zl.astype(np.int32)


def _lane_major(a, B, maxit, lpi):
    """walk8 (B, NG, 64*maxit, lpi) record rows (row 8j+s = step j of lane
    set s) -> (B, ST, NC) numpy, lane c = g*8*lpi + s*lpi + col."""
    a = np.asarray(a)
    ng = a.shape[1]
    return a.reshape(B, ng, 8 * maxit, 8, lpi).transpose(0, 2, 1, 3, 4) \
        .reshape(B, 8 * maxit, ng * 8 * lpi)


def _jax_chain(stream, luts, p0, zl, *, h, w, c, maxit=JW.MAXIT):
    B = stream.shape[0]
    zmax = int(zl.max())
    nc_pad, lpi = JW.plan_tpu8(zmax, LPI)
    posr, raw0, raw1, nst4, e_fin, out0, diag = JW._decode_walk8(
        jnp.asarray(stream), jnp.asarray(luts), jnp.asarray(p0),
        jnp.asarray(zl), nc_pad=nc_pad, lpi=lpi, maxit=maxit, interpret=True)
    d = int(diag)
    res = dict(e_fin=np.asarray(e_fin), out0=np.asarray(out0),
               ovf=bool(d & (1 << 30)))
    if res["ovf"]:
        return res
    steps = d
    unit = 8 * lpi
    ncl = min(-(-max(-(-zmax * 8 // 512), 1) // unit) * unit, nc_pad)
    rs, bpl, bpl_pad = 1 + w * c, w * c, _bpl_pad(w * c)
    H8 = -(-h // 8) * 8

    # each slice's entry carry: out0 plus the bytes of the rows before it
    p, r0, r1 = (_lane_major(a, B, maxit, lpi) for a in (posr, raw0, raw1))
    e = res["e_fin"][:, None, :]
    nst = np.asarray(nst4).reshape(B, nc_pad)
    rows = np.arange(8 * maxit)[None, :, None]
    recbit = (((r0 >> 9) & 1) == 1) & (rows < nst[:, None])
    dem = recbit & (r1 != 0) & (p < e) & (p + ((r0 >> 19) & 15) == e)
    rec = (recbit & (p >= e)) | dem
    ol = np.where(rec, np.where(dem, 1, (r0 >> 10) & 511), 0)
    carry = res["out0"][:, None, :] + np.cumsum(ol, axis=1) - ol

    metas, metbs, fail, eob, bad = [], [], False, None, None
    for k in range(-(-steps // PIECE)):
        sl = slice(8 * PIECE * k, 8 * PIECE * (k + 1))
        meta, metb, chk = _finalize_piece(
            posr[:, :, sl], raw0[:, :, sl], raw1[:, :, sl],
            jnp.maximum(nst4 - PIECE * k, 0), e_fin,
            jnp.asarray(carry[:, PIECE * k].astype(np.int32)),
            geom=(rs, h * rs, c, bpl_pad), ncg=ncl // unit)
        metas.append(np.asarray(meta).reshape(B, ncl, PIECE))
        metbs.append(np.asarray(metb).reshape(B, ncl, PIECE))
        chk = np.asarray(chk)
        fail |= chk[:, :, 0].any(axis=1)
        eob = chk[:, :, 1].min(axis=1) if eob is None else \
            np.minimum(eob, chk[:, :, 1].min(axis=1))
        bad = chk[:, :, 2].min(axis=1) if bad is None else \
            np.minimum(bad, chk[:, :, 2].min(axis=1))
    meta = np.concatenate(metas, axis=2).reshape(B, -1)
    metb = np.concatenate(metbs, axis=2).reshape(B, -1)
    dep = scatter_packed16_tpu(jnp.asarray(meta), H8 * (bpl_pad // 2),
                               metb=jnp.asarray(metb), interpret=True,
                               wide=True)
    res["raster"] = np.asarray(dep).view(np.uint16) \
        .reshape(B, H8, bpl_pad)[:, :h, :bpl]
    res["imgs"] = np.asarray(expand_tpu(
        jax.lax.bitcast_convert_type(dep, jnp.int32), h=h, w=w, c=c,
        bpl_pad=bpl_pad, interpret=True))
    res["ok"] = ~fail & (eob != JW._INF) & (eob <= bad) & \
        (((eob.astype(np.int64) + 7) >> 3) == zl - 4)
    return res


def _port_chain(stream, luts, p0, zl, *, h, w, c, maxit=TW.MAXIT):
    B = stream.shape[0]
    args = (torch.from_numpy(stream), torch.from_numpy(luts.astype(np.int64)),
            torch.from_numpy(p0), torch.from_numpy(zl))
    nc = TW.n_chunks(int(zl.max()))
    records, e_fin, out0, steps, ovf, passes = TW.decode_walk8(
        *args, n_chunks=nc, maxit=maxit)
    res = dict(e_fin=e_fin.numpy(), out0=out0.numpy(), ovf=bool(ovf.any()),
               nc=nc, passes=passes)
    *out, seed = TW.decode_kernel8(*args, h=h, w=w, c=c,
                                   zlib_len_max=int(zl.max()), maxit=maxit)
    assert (seed is not None) == res["ovf"]
    if res["ovf"]:  # the seed PK=1 resumes from
        assert out == [None, None]
        assert torch.equal(seed, TW.resume_seed(*records, e_fin))
        return res
    k8 = TW.trim_steps(int(steps), records[0].shape[1])
    meta, metb, _ = TW.finalize_records8(*records, e_fin, out0, k8=k8, h=h,
                                         bpl=w * c, c=c)
    res["raster"] = TW.scatter_packed16(
        meta.reshape(B, -1), metb.reshape(B, -1), h * w * c).numpy() \
        .view(np.uint16).reshape(B, h, w * c)
    res["imgs"], res["ok"] = (a.numpy() for a in out)
    return res


def _case(name):
    if name == "rgb_1pass":
        tiles = list(synthetic_corpus(3, size=32))
        imgs = np.stack([tiles[0], tiles[9]])
        pngs = T.encode_batch(imgs, 0, device="cpu")
    else:  # rgba_2pass: per-image tables
        tiles = list(synthetic_corpus(4, size=32))
        imgs = np.stack([tiles[9], tiles[0]])
        pngs = [golden.encode_image_to_memory(i, 32, 32, 4,
                                              T.FPNG_ENCODE_SLOWER)
                for i in imgs]
    return imgs, _pack(pngs)


@pytest.fixture(scope="module", params=["rgb_1pass", "rgba_2pass"])
def chains(request):
    imgs, packed = _case(request.param)
    _, h, w, c = imgs.shape
    return (imgs, _jax_chain(*packed, h=h, w=w, c=c),
            _port_chain(*packed, h=h, w=w, c=c), packed[3])


def test_entries_and_offsets_match_jax(chains):
    _, j, t, zl = chains
    assert not j["ovf"] and not t["ovf"]
    assert t["nc"] > 1 and t["passes"] > 1  # a real cross-chunk fixpoint
    nc = t["nc"]
    live = np.arange(nc)[None, :] * 512 < zl[:, None] * 8
    assert np.array_equal(np.where(live, t["e_fin"], 0),
                          np.where(live, j["e_fin"][:, :nc], 0))
    assert np.array_equal(np.where(live, t["out0"], 0),
                          np.where(live, j["out0"][:, :nc], 0))


def test_deposit_raster_matches_jax(chains):
    _, j, t, _ = chains
    assert np.array_equal(t["raster"], j["raster"])


def test_pixels_and_ok_match_jax(chains):
    imgs, j, t, _ = chains
    assert np.array_equal(t["ok"], j["ok"]) and t["ok"].all()
    assert np.array_equal(t["imgs"], j["imgs"])
    assert np.array_equal(t["imgs"], imgs)


def test_overflow_flag_matches_jax():
    """fpng_tpu's test_walk8_overflow_falls_back input: 2-pass Up-filter
    noise over a binary alphabet codes more than 16 tokens per chunk, so a
    maxit=2 walk (16 steps) overflows in both packages."""
    rng = np.random.default_rng(3)
    img = np.cumsum(rng.integers(0, 2, (32, 32, 3)), axis=0).astype(np.uint8)
    packed = _pack([golden.encode_image_to_memory(
        img, 32, 32, 3, T.FPNG_ENCODE_SLOWER)])
    j = _jax_chain(*packed, h=32, w=32, c=3, maxit=2)
    t = _port_chain(*packed, h=32, w=32, c=3, maxit=2)
    assert j["ovf"] and t["ovf"]


def _jacobi_reference(words, lut, p0, zl8, *, n_chunks, ST):
    """The walk and fixpoint as a plain Jacobi loop whose walks stop at
    their ST rows, as fpng_tpu's kernels do (an overflowing lane's exit is
    then short of its chunk end): entry[c] = exit[c-1] until nothing
    changes, re-walking a lane whose new entry is not among its first 32
    recorded positions."""
    B, NC = words.shape[0], n_chunks
    words64 = torch.nn.functional.pad(words.to(torch.int64) & TW.MASK32,
                                      (0, 2))
    lut64 = lut.to(torch.int64) & TW.MASK32
    p0 = p0.to(torch.int64)[:, None]
    bit0, live, bound = TW._lane_geometry(zl8, NC)
    posr, raw0, raw1 = (torch.zeros((B, ST, NC), dtype=torch.int64)
                        for _ in range(3))
    ent = bit0.expand(B, NC).clone()
    ent[:, :1] = p0
    ex, nst, ovf = TW._walk_plain(words64, lut64, ent, bound,
                                  live & (ent < bound), posr, raw0, raw1,
                                  cap=ST)
    passes, M = 1, min(32, ST)
    rows = torch.arange(M)[None, :, None]
    for _ in range(NC + 1):
        passes += 1
        e_new = torch.cat([p0, ex[:, :-1]], dim=1)
        chg = (e_new != ent) & live
        if not bool(chg.any()):
            break
        en, pr = e_new[:, None], posr[:, :M]
        hit = (pr == en) | \
            ((raw1[:, :M] != 0) & (pr + ((raw0[:, :M] >> 19) & 15) == en))
        member = (hit & (rows < nst[:, None])).any(dim=1)
        ent = torch.where(chg, e_new, ent)
        wm = chg & ~member
        ex2, nst2, ovf2 = TW._walk_plain(words64, lut64, ent, bound,
                                         wm & (ent < bound), posr, raw0, raw1,
                                         cap=ST)
        ex = torch.where(wm, ex2, ex)
        nst = torch.where(wm, nst2, nst)
        ovf = torch.where(wm, ovf2, ovf)
    i32 = torch.int32
    return (ent.to(i32), nst.to(i32), ovf, posr.to(i32), raw0.to(i32),
            raw1.to(i32), passes)


def _walk_args(packed):
    """Packed streams -> the walk's inputs (words, lut, p0, zl8, NC)."""
    stream, luts, p0, zl = packed
    return (TW.stream_words(torch.from_numpy(stream)),
            torch.from_numpy(luts.view(np.int32)), torch.from_numpy(p0),
            torch.from_numpy(zl * 8), TW.n_chunks(int(zl.max())))


def _image_ovf(out, zl8):
    live = TW._lane_geometry(zl8, out[0].shape[1])[1]
    return (out[2] & live).any(dim=1).tolist()


def _front_case(name):
    if name == "multiblock":  # one 256 x 256 tile: ~2 600 lanes, 21 tiles
        imgs = list(synthetic_corpus(3, size=256))[18][None]
        return _pack(T.encode_batch(imgs, 0, device="cpu"))
    return _case(name)[1]


@pytest.mark.parametrize("case", ["rgb_1pass", "rgba_2pass", "multiblock"])
def test_front_rule_leaves_converging_walks_unchanged(case):
    """On streams that fit walk8, the walk whose lanes walk on past their
    rows to exact exits gives exactly the outputs and pass count of the
    Jacobi loop whose walks stop at their rows (fpng_tpu's)."""
    words, lut, p0, zl8, nc = _walk_args(_front_case(case))
    out = TW.walk_fix8_plain(words, lut, p0, zl8, n_chunks=nc)
    ref = _jacobi_reference(words, lut, p0, zl8, n_chunks=nc,
                            ST=8 * TW.MAXIT)
    assert not any(_image_ovf(out, zl8)) and not any(_image_ovf(ref, zl8))
    assert int(out[6]) == ref[6] > 1
    for a, b in zip(out[:6], ref[:6]):
        assert torch.equal(a, b)


def _jax_walk8_ovf(packed, maxit=JW.MAXIT):
    """fpng_tpu's walk8 overflow flag for a batch (its diag bit 30)."""
    stream, luts, p0, zl = packed
    nc_pad, lpi = JW.plan_tpu8(int(zl.max()), LPI)
    diag = JW._decode_walk8(
        jnp.asarray(stream), jnp.asarray(luts), jnp.asarray(p0),
        jnp.asarray(zl), nc_pad=nc_pad, lpi=lpi, maxit=maxit,
        interpret=True)[-1]
    return bool(int(diag) & (1 << 30))


def _resumes_pk1(words, lut, p0, zl8, nc, maxit=TW.MAXIT):
    """B3's plain walk at 8 * maxit rows and B8's at ST8 on the same
    input: B3's converged entries and passes are B8's, bit for bit, and
    B8 seeded with them (resume_seed) reads 2 passes to the same entries.
    Returns B3's outputs."""
    out = TW.fixpoint_plain(words, lut, p0, zl8, n_chunks=nc, ST=8 * maxit)
    pk1 = TS.walk_fix_plain(words, lut, p0, zl8, n_chunks=nc)
    assert torch.equal(out[0], pk1[0]) and int(out[6]) == int(pk1[6])
    seed = TW.resume_seed(*out[3:6], out[1], out[0])
    seeded = TS.walk_fix_plain(words, lut, p0, zl8, n_chunks=nc, seed=seed)
    assert torch.equal(seeded[0], pk1[0]) and int(seeded[6]) == 2
    return out


def test_overflowing_image_stops_beside_a_converging_one():
    """[tiles[6], tiles[9]] (2-pass, 4 channels): image 0 overflows walk8.
    Its overflowing lanes walk on to their chunk ends, so B3 converges in
    the PK=1 walk's 3 passes to the PK=1 walk's entries, where the Jacobi
    loop whose walks stop at their rows runs 16; the image overflow flags
    are the Jacobi loop's and fpng_tpu's.  Image 1 fits: every output is
    the Jacobi loop's, and its entries, offsets and pixels equal its decode
    on its own."""
    tiles = list(synthetic_corpus(4, size=32))
    imgs = np.stack([tiles[6], tiles[9]])
    pngs = [golden.encode_image_to_memory(i, 32, 32, 4, T.FPNG_ENCODE_SLOWER)
            for i in imgs]
    packed = _pack(pngs)
    words, lut, p0, zl8, nc = _walk_args(packed)
    out = _resumes_pk1(words, lut, p0, zl8, nc)
    ref = _jacobi_reference(words, lut, p0, zl8, n_chunks=nc,
                            ST=8 * TW.MAXIT)
    assert int(out[6]) == 3 and ref[6] == 16
    assert _image_ovf(out, zl8) == _image_ovf(ref, zl8) == [True, False]
    for a, b in zip(out[:6], ref[:6]):
        assert torch.equal(a[1], b[1])
    assert [_jax_walk8_ovf(_pack([p])) for p in pngs] == [True, False]

    args = [torch.from_numpy(a) for a in packed]
    records, e_fin, out0, _, ovf, _ = TW.decode_walk8(
        *args, n_chunks=nc)
    assert ovf.tolist() == [True, False]
    solo = _pack(pngs[1:])
    s_rec, s_e, s_out0, _, s_ovf, _ = TW.decode_walk8(
        *(torch.from_numpy(a) for a in solo),
        n_chunks=TW.n_chunks(int(solo[3].max())))
    n1 = s_e.shape[1]
    assert not s_ovf.any()
    assert torch.equal(e_fin[1:, :n1], s_e) and \
        torch.equal(out0[1:, :n1], s_out0)
    got, ok = TW.finish_decode(
        TW.finalize_records8, [r[1:] for r in records], e_fin[1:], out0[1:],
        args[3][1:], k8=8 * TW.MAXIT, h=32, w=32, c=4)
    assert bool(ok.all()) and np.array_equal(got.numpy(), imgs[1:])


@pytest.mark.parametrize("case, n_ovf, ref_passes",
                         [("maxit2", 1, 11), ("binary", 1, 44)])
def test_overflowing_walk_stops(case, n_ovf, ref_passes):
    """test_overflow_flag_matches_jax's input at maxit=2, and a 2-pass
    image of bytes in {0, 1} (chip_smoke.py's overflow image, 16 rows):
    the walk's overflowing lanes walk on to exact exits, so B3 reaches the
    PK=1 walk's entries in its passes, where the Jacobi loop whose walks
    stop at their rows cascades through `ref_passes`; its n_ovf overflowing
    image is flagged as by the Jacobi loop and fpng_tpu's walk8."""
    if case == "maxit2":
        rng = np.random.default_rng(3)
        img = np.cumsum(rng.integers(0, 2, (32, 32, 3)), axis=0) \
            .astype(np.uint8)
        maxit = 2
    else:
        img = np.random.default_rng(0).integers(0, 2, (16, 256, 3)) \
            .astype(np.uint8)
        maxit = TW.MAXIT
    h, w, _ = img.shape
    packed = _pack([golden.encode_image_to_memory(
        img, w, h, 3, T.FPNG_ENCODE_SLOWER)])
    words, lut, p0, zl8, nc = _walk_args(packed)
    out = _resumes_pk1(words, lut, p0, zl8, nc, maxit)
    ref = _jacobi_reference(words, lut, p0, zl8, n_chunks=nc, ST=8 * maxit)
    assert ref[6] == ref_passes > int(out[6])
    assert _image_ovf(out, zl8) == _image_ovf(ref, zl8) == [True] * n_ovf
    assert _jax_walk8_ovf(packed, maxit)


def test_resume_seed_walks_a_second_literal_entry_from_its_pair():
    """synthetic_corpus(4, 256)[4], 1-pass (a colour ramp under an alpha
    ramp), overflows walk8, and many of B3's converged entries are the
    second literal of a literal pair.  B8 seeded with the bare entries
    walks from them, pairs the literals after them otherwise and needs
    more passes, to other entries; resume_seed starts those lanes at the
    pair (~p), so B8 reads 2 passes to the unseeded B8's entries, and the
    resumed decode gives the tile back."""
    img = list(synthetic_corpus(4, size=256))[4]
    packed = _pack(T.encode_batch(img[None], 0, device="cpu"))
    words, lut, p0, zl8, nc = _walk_args(packed)
    out = _resumes_pk1(words, lut, p0, zl8, nc)
    assert _image_ovf(out, zl8) == [True]
    seed = TW.resume_seed(*out[3:6], out[1], out[0])
    assert int((seed < 0).sum()) > 100
    bare = TS.walk_fix_plain(words, lut, p0, zl8, n_chunks=nc,
                             seed=out[0].clone())
    assert int(bare[6]) > 2 and not torch.equal(bare[0], out[0])
    args = [torch.from_numpy(a) for a in packed]
    got, ok = TS.decode_kernel_pk1(*args, h=256, w=256, c=4,
                                   zlib_len_max=int(packed[3].max()),
                                   seed=seed)
    assert bool(ok.all()) and np.array_equal(got[0].numpy(), img)


def _overflowing_rgba():
    """A 2-pass 4-channel tile that needs more than 96 steps in a chunk."""
    img = list(synthetic_corpus(4, size=32))[6]
    return img, golden.encode_image_to_memory(img, 32, 32, 4,
                                              T.FPNG_ENCODE_SLOWER)


def test_walk8_overflow_falls_to_chunked_decode():
    """A walk8 overflow now falls to the PK=1 walk (fpng_tpu's chain), not
    to the chunked decode: the image decodes on the device path, counted
    once in walk8_overflows and once under paths["pk1"]."""
    img, png = _overflowing_rgba()
    stream, luts, p0, zl = _pack([png])
    t = _port_chain(stream, luts, p0, zl, h=32, w=32, c=4)
    assert t["ovf"]
    n0, d0 = TD.decode_batch.walk8_overflows, TD.decode_batch.device_images
    k0, h0 = TD.decode_batch.paths["pk1"], TD.decode_batch.host_handoffs
    sts, outs = T.decode_batch([png], 4, device="cpu")
    assert sts == [0] and np.array_equal(outs[0], img)
    assert TD.decode_batch.walk8_overflows == n0 + 1
    assert TD.decode_batch.device_images == d0 + 1
    assert TD.decode_batch.paths["pk1"] == k0 + 1
    assert TD.decode_batch.host_handoffs == h0


def _small_batch():
    tiles = list(synthetic_corpus(3, size=32))
    imgs = np.stack([tiles[0][:21, :13], tiles[3][:21, :13]])
    stream, luts, p0, zl = _pack(T.encode_batch(imgs, 0, device="cpu"))
    return imgs, (torch.from_numpy(stream),
                  torch.from_numpy(luts.astype(np.int64)),
                  torch.from_numpy(p0).long(), torch.from_numpy(zl).long())


@pytest.mark.parametrize("walk8", ["1", "0"])
def test_dispatch_takes_walk8_by_default(walk8, monkeypatch):
    """FPNG_TPU_WALK8=0 selects the PK=1 walk, as in fpng_tpu."""
    monkeypatch.setenv("FPNG_TPU_WALK8", walk8)
    imgs, args = _small_batch()
    got, ok, ovf, path = TD.dispatch_kernel(
        *args, h=21, w=13, c=3, zmax=int(args[3].max()))
    assert path == ("walk8" if walk8 == "1" else "pk1")
    assert ok.all() and not ovf.any()
    assert np.array_equal(got.numpy(), imgs)


@pytest.mark.parametrize("walk8", ["1", "0"])
def test_raster_past_the_gate_takes_the_chunked_decode(walk8, monkeypatch):
    """Past ops/walk8.fits the dispatch takes the chunked decode whatever
    FPNG_TPU_WALK8 says.  The gate is asked about the batch's own raster;
    it answers as it would for a raster past 2^27 allocated slots."""
    monkeypatch.setenv("FPNG_TPU_WALK8", walk8)
    asked = []

    def refuse(h, bpl):
        asked.append((h, bpl))
        return False

    monkeypatch.setattr(TD, "fits", refuse)
    imgs, args = _small_batch()
    got, ok, ovf, path = TD.dispatch_kernel(
        *args, h=21, w=13, c=3, zmax=int(args[3].max()))
    assert asked == [(21, 39)] and path == "chunked"
    assert ok.all() and not ovf.any()
    assert np.array_equal(got.numpy(), imgs)


@pytest.mark.parametrize("h,w,c,fits", [
    (2160, 3840, 3, True), (8184, 4096, 4, True), (8189, 4096, 4, True),
    (1, 1, 3, True), (9000, 4000, 4, True), (5824, 7680, 3, True),
    (5832, 7680, 3, True), (46601, 7680, 3, True), (46602, 7680, 3, False),
    (16384, 16384, 4, False), (10800, 21600, 3, True)])
def test_walk8_gate_counts_allocated_rows(h, w, c, fits):
    """The walk path's limit is the port's own, h * (bpl + 1) < 2^30 (B4's
    int32 output offsets), counted on the raster with its filter bytes and
    no row padding.  fpng_tpu's gate (2^27 allocated slots) refused 8189
    rows of 16384 slots, 9000 x 16000 and 5832 x 23040; the port walks
    them.  46601 x 7680 x 3 is the tallest 4K-wide raster under 2^30
    (chip_smoke.py's walk_gate_edge phase), 16384 x 16384 x 4 lies just
    past it, and the 10800 x 21600 x 3 whole-globe raster (699.85 M
    bytes) lies within it."""
    assert TW.fits(h, w * c) == fits
    assert fits == (h * (w * c + 1) < 1 << 30)


@pytest.mark.parametrize("steps,want", [(0, 8), (8, 8), (9, 16), (69, 80),
                                        (95, 96), (96, 96)])
def test_trim_steps(steps, want):
    assert TW.trim_steps(steps, 96) == want


# ---------------------------------------------------------------------------
# B4's tiling (csrc/finalize8.cu): a Python twin against the plain version
# ---------------------------------------------------------------------------

FIN_LANES, FIN_WARPS, FIN_ROWS = 32, 8, 4  # kFinLanes, kFinWarps, kFinRows
INF = TW.INF


def _fastdiv(d):
    """make_fastdiv: (m, k) with n // d == (n * m) >> k for 0 <= n < 2^31."""
    k = 31 + (int(d - 1).bit_length() if d > 1 else 0)
    return ((1 << k) + d - 1) // d, k


def _fdiv(n, fd):
    return (np.asarray(n).astype(np.uint64) * np.uint64(fd[0])) >> \
        np.uint64(fd[1])


@pytest.mark.parametrize("d", [1, 2, 3, 4, 7, 13, 97, 256, 769, 11521,
                               (1 << 20) + 1, (1 << 30) - 1])
def test_finalize_fastdiv_is_exact(d):
    """The finalize's multiply-shift division equals integer division over
    0 <= n < 2^31: near 0 and 2^31, on both sides of random multiples of
    d and of the last one below 2^31, and on random n (n * m stays below
    2^64)."""
    rng = np.random.default_rng(d)
    m, k = fd = _fastdiv(d)
    assert m < 1 << 33 and k <= 62
    top = (1 << 31) - 1
    mult = rng.integers(1, top // d + 1, 2000)[:, None] * d + \
        np.arange(-1, 2)
    n = np.concatenate([
        np.arange(0, 3000), top - np.arange(0, 3000), mult.ravel(),
        (top // d) * d + np.arange(-2, 2), rng.integers(0, 1 << 31, 20000)])
    n = n[(n >= 0) & (n <= top)].astype(np.int64)
    assert int(n.max()) * m < 1 << 64
    assert np.array_equal(_fdiv(n, fd).astype(np.int64), n // d)


def _finalize_twin(posr, raw0, raw1, nst, e_fin, out0, *, k8, h, bpl, c):
    """csrc/finalize8.cu step by step: a block takes 32 lanes of one image
    and walks down them in tiles of 8 warps x 4 rows; each warp loads its
    4 rows of every lane (rows past the step count read as zeros), sums
    their output lengths, the warp sums are scanned on top of the column
    total carried from the tiles above, then each row's record and checks
    follow from its offset; the checks reduce per thread, per warp, per
    block, and one set of atomics a block updates chk."""
    posr, raw0, raw1, nst, e_fin, out0 = (
        np.asarray(a, np.int64) for a in (posr, raw0, raw1, nst, e_fin,
                                          out0))
    B, _, NC = posr.shape
    rs, total, n_slots = bpl + 1, h * (bpl + 1), h * bpl
    frs, fc = _fastdiv(rs), _fastdiv(c)
    meta = np.full((B, k8, NC), -1, np.int64)
    metb = np.full((B, k8, NC), -1, np.int64)
    chk = np.tile(np.array([0, INF, INF], np.int64), (B, 1))
    W_, R = FIN_WARPS, FIN_ROWS
    for b in range(B):
        for l0 in range(0, NC, FIN_LANES):
            lc = l0 + np.arange(FIN_LANES)
            act = lc < NC
            lcc = np.minimum(lc, NC - 1)
            e_l = np.where(act, e_fin[b, lcc], 0)
            n_l = np.where(act, nst[b, lcc], 0)
            carry = np.where(act, out0[b, lcc], 0)
            fail = np.zeros((W_, FIN_LANES), bool)
            eobm = np.full((W_, FIN_LANES), INF, np.int64)
            badm = eobm.copy()
            for t0 in range(0, k8, W_ * R):
                j = t0 + np.arange(W_)[:, None] * R + np.arange(R)  # (W, R)
                live = act & (j[..., None] < k8) & (j[..., None] < n_l)
                jc = np.minimum(j, posr.shape[1] - 1)[..., None]
                p = np.where(live, posr[b, jc, lcc], 0)
                r0 = np.where(live, raw0[b, jc, lcc], 0)
                r1 = np.where(live, raw1[b, jc, lcc], 0)
                recbit = ((r0 >> 9) & 1) == 1
                clen = (r0 >> 19) & 15
                dem = recbit & (r1 != 0) & (p < e_l) & (p + clen == e_l)
                rec = (recbit & (p >= e_l)) | dem
                outlen = np.where(dem, 1, (r0 >> 10) & 511)
                part = np.where(rec, outlen, 0).sum(axis=1)  # (W, lanes)
                pre = carry + np.cumsum(part, axis=0) - part
                carry = carry + part.sum(axis=0)
                # within a warp, its rows in order
                op_all = pre[:, None] + np.cumsum(
                    np.where(rec, outlen, 0), axis=1) - np.where(
                    rec, outlen, 0)
                for w in range(W_):
                    for i in range(R):
                        jj = t0 + w * R + i
                        if jj >= k8:
                            continue
                        ok = act
                        op, sym0 = op_all[w, i], r0[w, i] & 511
                        s2 = r1[w, i] & 0xFF
                        d, rc, ol = dem[w, i], rec[w, i], outlen[w, i]
                        sym = np.where(d, s2, sym0)
                        two = rc & (r1[w, i] != 0) & ~d
                        q = _fdiv(op, frs).astype(np.int64)
                        rowpos = op - q * rs
                        rowpos2 = np.where(rowpos + 1 == rs, 0, rowpos + 1)
                        lit = rc & (sym < 256) & (rowpos != 0) & (op < total)
                        lit2 = two & (rowpos2 != 0) & (op + 1 < total)
                        lit2o = lit2 & ~lit
                        off = q * bpl + np.where(lit2o, rowpos2, rowpos) - 1
                        meta[b, jj, lc[ok]] = np.clip(off, 0, n_slots)[ok]
                        val = np.where(lit | lit2o, np.where(
                            lit, sym, s2) | 0x100, 0) | np.where(
                            lit & lit2, (s2 | 0x100) << 16, 0)
                        metb[b, jj, lc[ok]] = val[ok]
                        lv = rc & (op < total)
                        x = rowpos - 1
                        f = lv & (sym > 285)
                        fexp = np.where(op >= rs, 2, 0)
                        f |= lv & (rowpos == 0) & ((sym >= 256) |
                                                   (sym != fexp))
                        xm = np.maximum(x, 0)
                        xc = (rowpos >= 1) & (
                            xm - _fdiv(xm, fc).astype(np.int64) * c == 0)
                        mok = xc & (ol - _fdiv(ol, fc).astype(np.int64) * c
                                    == 0) & (x + ol <= bpl)
                        f |= lv & (((r0[w, i] >> 23) & 1) == 1) & ~mok
                        f |= lv & (rowpos >= 1) & ~xc & (sym >= 256)
                        f |= lv & (sym == 256)
                        at = rc & (op == total)
                        eobm[w] = np.where(at & (sym == 256) & ok, np.minimum(
                            eobm[w], p[w, i] + clen[w, i]), eobm[w])
                        badm[w] = np.where(at & (sym != 256) & ok, np.minimum(
                            badm[w], p[w, i]), badm[w])
                        op2 = op + 1
                        f |= two & (op2 < total) & (rowpos2 == 0) & \
                            (s2 != np.where(op2 >= rs, 2, 0))
                        badm[w] = np.where(two & (op2 == total) & ok,
                                           np.minimum(badm[w], p[w, i] +
                                                      clen[w, i]), badm[w])
                        fail[w] |= f & ok
            # warp vote / min, then the block, then one set of atomics
            wf, we, wb = fail.any(axis=1), eobm.min(axis=1), badm.min(axis=1)
            if wf.any():
                chk[b, 0] |= 1
            chk[b, 1] = min(chk[b, 1], we.min())
            chk[b, 2] = min(chk[b, 2], wb.min())
    assert (meta >= 0).all() and (metb >= -(1 << 31)).all()
    return (torch.from_numpy(meta.astype(np.int32)),
            torch.from_numpy(metb.astype(np.int64).astype(np.int32)),
            torch.from_numpy(chk.astype(np.int32)))


def _synthetic_records(rng, B, ST, NC, *, h, bpl, c):
    """Walk-like records: each lane's steps advance its bit position by
    clen; literal (1 or 2), match and EOB steps; some steps before e_fin,
    one two-literal step per image ending exactly at e_fin (demoted);
    lanes with no steps; offsets spread over and past the raster."""
    total = h * (bpl + 1)
    posr = np.zeros((B, ST, NC), np.int64)
    raw0 = np.zeros_like(posr)
    raw1 = np.zeros_like(posr)
    nst = rng.integers(0, ST + 1, (B, NC))
    nst[:, ::7] = 0
    e_fin = rng.integers(0, 40, (B, NC))
    for b in range(B):
        for lc in range(NC):
            pos = int(rng.integers(0, 30))
            for j in range(ST):
                clen = int(rng.integers(1, 16))
                kind = rng.random()
                if kind < 0.55:
                    sym, outl, r1 = int(rng.integers(0, 256)), 1, 0
                    if rng.random() < 0.4:  # two literals
                        outl, r1 = 2, 0x100 | int(rng.integers(0, 256))
                    m = 0
                elif kind < 0.9:
                    sym, outl, r1, m = 257 + int(rng.integers(0, 29)), \
                        c * int(rng.integers(1, 4)) + int(rng.random() < 0.2),\
                        0, 1
                elif kind < 0.95:
                    sym, outl, r1, m = 256, 0, 0, 0
                else:
                    sym, outl, r1, m = int(rng.choice([0, 2, 300])), 1, 0, 0
                recbit = int(rng.random() < 0.92)
                posr[b, j, lc] = pos
                raw0[b, j, lc] = sym | recbit << 9 | outl << 10 | \
                    clen << 19 | m << 23
                raw1[b, j, lc] = r1
                pos += clen
        # a two-literal step whose second literal starts at e_fin
        lc = NC // 2
        nst[b, lc] = max(nst[b, lc], 3)
        raw0[b, 1, lc] = 65 | 1 << 9 | 2 << 10 | 5 << 19
        raw1[b, 1, lc] = 0x100 | 66
        e_fin[b, lc] = posr[b, 1, lc] + 5
    # rows past a lane's step count hold junk the finalize must not read
    junk = np.arange(ST)[None, :, None] >= nst[:, None]
    raw0 = np.where(junk, 0x7FFFFFFF, raw0)
    out0 = rng.integers(0, total + 3, (B, NC))
    out0[:, 0] = 0
    out0[0, 1] = total - 1
    return [torch.from_numpy(a.astype(np.int32)) for a in
            (posr, raw0, raw1, nst, e_fin, out0)]


@pytest.mark.parametrize("B,ST,NC,k8", [
    (2, 40, 37, 17),    # k8 and NC not multiples of the row and lane tiles
    (2, 96, 70, 96),    # walk8's rows: three tiles
    (1, 70, 32, 45),    # one full lane tile, a partial last row tile
    (3, 9, 5, 1)])      # one row, fewer lanes than a warp
def test_finalize_tiling_matches_plain(B, ST, NC, k8):
    """The tile decomposition of csrc/finalize8.cu (Python twin) gives
    finalize_records8_plain's meta, metb and chk exactly, on records with
    dead lanes (nst = 0), junk past each lane's step count, and a demoted
    two-literal step at e_fin."""
    rng = np.random.default_rng(ST * 100 + NC)
    h, bpl, c = 6, 9, 3
    rec = _synthetic_records(rng, B, ST, NC, h=h, bpl=bpl, c=c)
    kw = dict(k8=k8, h=h, bpl=bpl, c=c)
    want = TW.finalize_records8_plain(*rec, **kw)
    got = _finalize_twin(*rec, **kw)
    for g, w_, what in zip(got, want, ("meta", "metb", "chk")):
        assert torch.equal(g, w_), what
    posr, raw0, raw1, nst, e_fin, _ = rec
    e3 = e_fin[:, None]
    dem = (((raw0 >> 9) & 1) == 1) & (raw1 != 0) & (posr < e3) & \
        (posr + ((raw0 >> 19) & 15) == e3) & \
        (torch.arange(ST)[None, :, None] < torch.clamp(nst, max=k8)[:, None])
    assert bool((nst == 0).any())
    assert bool(dem.any()) or k8 == 1
