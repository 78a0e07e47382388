"""The port's largest rasters, on the CPU: 64-bit bit positions, the memory
plan's tiers and the memory model at the whole-globe shape.

A stream of 2^31 bits or more (268 MB: the 10800 x 21600 x 3 whole-globe
raster's) walks with int64 positions (ops/walk8.pos_dtype).  The dtype
switches by size, so here the threshold is lowered to make small streams
take the wide path, whose every output must equal the narrow one's.  The
tier plan
(models/decoder.plan_tiers) is forced tier by tier with mem_budget; each
tier's pixels and statuses are held against the plain reference
(pngbench/pngref.py, NumPy and zlib) and fpng_tpu's decoder.  Tolerance
zero.
"""

import numpy as np
import pytest
import torch

import fpng_tpu as F
import fpng_tpu_torch as T
from fpng_tpu_torch import golden
from fpng_tpu_torch.models import decoder as TD
from fpng_tpu_torch.ops import specdec as SD
from fpng_tpu_torch.ops import specdec_tpu as TS
from fpng_tpu_torch.ops import walk8 as TW
from fpng_tpu_torch.train import synthetic_corpus
from fpng_tpu_torch.utils import trace
from pngbench import pngref

# 4-channel 32 x 32 2-pass tiles: 6 overflows walk8 alone, 9 and 0 do not
TILES = [9, 6, 0]
GLOBE = (10800, 21600, 3)


def _tiles():
    tiles = list(synthetic_corpus(4, size=32))
    imgs = np.stack([tiles[i] for i in TILES])
    return imgs, [golden.encode_image_to_memory(i, 32, 32, 4,
                                                T.FPNG_ENCODE_SLOWER)
                  for i in imgs]


def _args(pngs):
    stream, luts, p0, zl = TD.pack_streams([TD._parse_one(p) for p in pngs])
    return tuple(torch.from_numpy(a) for a in (
        stream, luts.astype(np.int64), p0, zl)), int(zl.max())


@pytest.fixture(scope="module")
def case():
    """The tiles, their files, fpng_tpu's decode and pngref's reading."""
    imgs, pngs = _tiles()
    ref = [pngref.read(p) for p in pngs]
    assert all(np.array_equal(r, i) for r, i in zip(ref, imgs))
    return imgs, pngs, F.decode_batch(pngs, 4)


def _wide(monkeypatch):
    monkeypatch.setattr(TW, "POS32_BITS", 0)


def test_pos_dtype_switches_at_2_31_bits():
    """Positions are int32 while (lanes + 1) x 512 bits stay under 2^31,
    so every cell but the globe's keeps int32 records."""
    edge = (1 << 31) // TW.S - 1
    assert TW.pos_dtype(edge - 1) == torch.int32
    assert TW.pos_dtype(edge) == torch.int64
    assert TW.pos_dtype(TW.n_chunks(1085989 * 64)) == torch.int32
    assert TW.pos_dtype(TW.n_chunks(326_000_000)) == torch.int64


@pytest.mark.parametrize("tier", ["walk8", "pk1"])
def test_wide_walk_equals_the_narrow_one(case, tier, monkeypatch):
    """The walk chain with int64 positions: the same entries, offsets,
    steps, overflow flags, pixels and ok flags as with int32, on walk8
    (images 9 and 0) and on PK=1 resumed from walk8's entries (image 6)."""
    imgs, pngs, _ = case
    idx = [0, 2] if tier == "walk8" else [1]
    args, zmax = _args([pngs[i] for i in idx])
    nc = TW.n_chunks(zmax)
    narrow = TW.decode_walk8(*args, n_chunks=nc)
    n_out = TD._walk_chain(*args, h=32, w=32, c=4, zmax=zmax)
    _wide(monkeypatch)
    wide = TW.decode_walk8(*args, n_chunks=nc)
    assert wide[0][0].dtype == wide[1].dtype == torch.int64
    assert narrow[0][0].dtype == torch.int32
    for a, b in zip(narrow[1:], wide[1:]):
        assert torch.equal(a.to(torch.int64), b.to(torch.int64))
    w_out = TD._walk_chain(*args, h=32, w=32, c=4, zmax=zmax)
    assert n_out[3] == w_out[3] == tier
    assert torch.equal(n_out[0], w_out[0]) and torch.equal(n_out[1], w_out[1])
    assert np.array_equal(w_out[0].numpy(), imgs[idx]) and w_out[1].all()


def test_wide_resume_seed_and_finalize_check(case, monkeypatch):
    """The resume seed keeps the sign of ~p in int64, and the finalize's
    check triple takes int64's largest value for "no position": a lane set
    cut before its EOB reads no eob_end, as the int32 triple reads INF."""
    _, pngs, _ = case
    args, zmax = _args([pngs[1]])
    nc = TW.n_chunks(zmax)
    recs, e_fin, out0, _, ovf, _ = TW.decode_walk8(*args, n_chunks=nc)
    seed = TW.resume_seed(*recs, e_fin)
    _wide(monkeypatch)
    w_recs, w_fin, w_out0, _, w_ovf, _ = TW.decode_walk8(*args, n_chunks=nc)
    w_seed = TW.resume_seed(*w_recs, w_fin)
    assert bool(ovf.all()) and bool(w_ovf.all())
    assert w_seed.dtype == torch.int64
    assert torch.equal(seed.to(torch.int64), w_seed)
    kw = dict(k8=8, h=32, bpl=128, c=4)
    chk = TW.finalize_records8(*recs, e_fin, out0, **kw)[2]
    w_chk = TW.finalize_records8(*w_recs, w_fin, w_out0, **kw)[2]
    assert chk.dtype == torch.int32 and w_chk.dtype == torch.int64
    assert int(chk[0, 1]) == TW.INF
    assert int(w_chk[0, 1]) == torch.iinfo(torch.int64).max


def _budget(tier, nc, B):
    """A budget that plan_tiers answers with `tier` for B 32 x 32 x 4
    images over nc lanes, where the chunked decode's model fits (patched
    to 0 bytes; its real model at this size, 1.1 MB an image, lies past
    the PK=1 decode's 0.5 MB) or, for "walk8" and "none", where it does
    not."""
    out = B * 32 * 128
    pk1 = TW.decode_bytes(1, nc, TS.ST8, 32, 128) + out
    w8 = TW.decode_bytes(1, nc, 8 * TW.MAXIT, 32, 128) + out
    assert w8 < pk1
    return {"walk8_pk1": pk1, "walk8_chunked": w8, "walk8": w8,
            "chunked": w8 - 1, "none": w8 - 1, "pk1_straight": pk1}[tier]


def _no_chunked_bytes(monkeypatch):
    monkeypatch.setattr(TD, "chunked_bytes", lambda *a: 0)


@pytest.mark.parametrize("tier, walk8, path, want_tier", [
    ("walk8_pk1", "1", "pk1", "walk8_pk1"),
    ("walk8_chunked", "1", "chunked", "walk8_chunked"),
    ("chunked", "1", "chunked", "chunked_no_room"),
    ("pk1_straight", "0", "pk1", "walk8_pk1"),
    ("walk8_chunked", "0", "chunked", "chunked_no_room")])
def test_tier_plan_decodes_each_tier_bit_exact(case, tier, walk8, path,
                                               want_tier, monkeypatch):
    """mem_budget makes plan_tiers choose each tier: walk8 -> PK=1 where
    one image's PK=1 decode fits (image 6 overflows walk8 and decodes on
    PK=1); walk8 -> chunked where only its walk8 decode and the chunked
    decode fit (image 6 then takes the chunked decode, never PK=1); the
    chunked decode where no walk fits; with FPNG_TPU_WALK8=0, PK=1 where
    it fits and the chunked decode where it does not.  Every tier is
    bit-exact against pngref and fpng_tpu, one image a sub-batch."""
    imgs, pngs, (f_sts, f_imgs) = case
    monkeypatch.setenv("FPNG_TPU_WALK8", walk8)
    _no_chunked_bytes(monkeypatch)
    args, zmax = _args(pngs)
    nc = TW.n_chunks(zmax)
    budget = _budget(tier, nc, len(pngs))
    nb = args[0].shape[1]
    assert TD.plan_tiers(len(pngs), nb, 32, 32, 4, zmax, budget)[0] == \
        want_tier
    sub0, ovf0 = TD.decode_batch.sub_batches, TD.decode_batch.walk8_overflows
    got, ok, overflow, got_path = TD.dispatch_kernel(
        *args, h=32, w=32, c=4, zmax=zmax, mem_budget=budget)
    assert got_path == path and not overflow.any() and ok.all()
    assert all(np.array_equal(pngref.read(p), g)
               for p, g in zip(pngs, got.numpy()))
    assert f_sts == [0] * 3
    assert all(np.array_equal(a, b) for a, b in zip(got.numpy(), f_imgs))
    subs = TD.decode_batch.sub_batches - sub0
    ovfs = TD.decode_batch.walk8_overflows - ovf0
    if want_tier == "chunked_no_room":
        assert subs == 1 and ovfs == 0
    elif walk8 == "1":
        assert subs == 3 and ovfs == 1
    else:
        assert subs == 3 and ovfs == 0


def test_tier_plan_never_launches_pk1_without_room(case, monkeypatch):
    """Where one image's PK=1 decode does not fit, PK=1 is never launched,
    whatever walk8 does; the images it would have taken are counted under
    decoder.chunked_no_room in a traced call."""
    _, pngs, _ = case
    _no_chunked_bytes(monkeypatch)
    args, zmax = _args(pngs)
    budget = _budget("walk8_chunked", TW.n_chunks(zmax), len(pngs))
    calls = []
    real = TS.decode_kernel_pk1
    monkeypatch.setattr(TD, "decode_kernel_pk1",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    trace.reset()
    with trace.within(trace.begin("decode_batch", force=True)):
        TD.dispatch_kernel(*args, h=32, w=32, c=4, zmax=zmax,
                           mem_budget=budget)
    counters = trace.snapshot()["counters"]
    trace.reset()
    assert calls == []
    assert counters["decoder.images"] == 3
    assert counters["decoder.tier.walk8_chunked"] == 3
    assert counters["decoder.chunked_images"] == 1
    assert counters["decoder.chunked_no_room"] == 1
    assert "decoder.chunked_past_limit" not in counters


@pytest.mark.parametrize("tier", ["walk8", "none"])
def test_tier_plan_raises_where_no_decode_fits(case, tier):
    """With the chunked decode's real model: where walk8 alone fits, the
    plan takes it and image 6's walk8 overflow raises MemoryError instead
    of launching a decode that cannot fit; where no tier fits, the plan
    raises before anything launches."""
    _, pngs, _ = case
    args, zmax = _args(pngs)
    nb, nc = args[0].shape[1], TW.n_chunks(zmax)
    budget = _budget(tier, nc, len(pngs))
    assert SD.chunked_bytes(1, nb, 32, 32, 4) > budget
    kw = dict(h=32, w=32, c=4, zmax=zmax, mem_budget=budget)
    sub0, ovf0 = TD.decode_batch.sub_batches, TD.decode_batch.walk8_overflows
    if tier == "none":
        with pytest.raises(MemoryError, match="no tier fits"):
            TD.plan_tiers(len(pngs), nb, 32, 32, 4, zmax, budget)
        with pytest.raises(MemoryError, match="no tier fits"):
            TD.dispatch_kernel(*args, **kw)
        assert TD.decode_batch.sub_batches == sub0
        return
    assert TD.plan_tiers(len(pngs), nb, 32, 32, 4, zmax, budget) == \
        ("walk8", [(0, 1), (1, 2), (2, 3)])
    with pytest.raises(MemoryError, match="overflowed"):
        TD.dispatch_kernel(*args, **kw)
    assert TD.decode_batch.sub_batches - sub0 == 2  # image 6 is the second
    assert TD.decode_batch.walk8_overflows - ovf0 == 1


def test_chunked_decode_has_no_int32_position_sentinel():
    """The chunked decode's "no position" lies past every bit position of
    a stream it takes (rasters under 2^31 bytes, streams past 2^31 bits:
    the globe's true EOB at about 2.6 G bits read as no EOB under the old
    0x7FFFFFFF, and the image as NOT_FPNG)."""
    assert SD._NO_POS > 8 * (1 << 31) * 2


@pytest.mark.parametrize("lanes", [5_100_000, 10_936_000])
@pytest.mark.parametrize("ST", [8 * TW.MAXIT, TS.ST8])
def test_decode_bytes_at_the_globe_shape(lanes, ST):
    """decode_bytes at 10800 x 21600 x 3 against a hand count of the
    finish, its largest stage: the records (an int64 position and two
    int32 words a row), meta and metb (two int32 words a row), three lane
    arrays (the int64 entry, nst, out0), the int16 raster, the uint8 image
    and B6's scratch; each of some thirty buffers may take up to 1 MiB
    more in the allocator's rounding."""
    h, w, c = GLOBE
    bpl = w * c
    assert TW.fits(h, bpl) and TW.pos_dtype(lanes) == torch.int64
    _, strip, bands, strips = TW.tiling(h, bpl)
    hand = lanes * ST * (8 + 4 + 4) + lanes * ST * 8 + lanes * (8 + 4 + 4) \
        + 2 * h * bpl + h * bpl + TW._scratch_bytes(1, strip, bands, strips)
    got = TW.decode_bytes(1, lanes, ST, h, bpl)
    assert hand <= got <= hand + (32 << 20)


@pytest.mark.parametrize("nb", [1 << 29, 1 << 30])
def test_chunked_bytes_at_the_globe_shape(nb):
    """chunked_bytes at 10800 x 21600 x 3 against a hand count of its two
    largest stages, each with the int64 windows (8 B a stream byte), B10's
    words (2 B a raster byte) and 48 int64 lane arrays: the expansion,
    with four int32 record arrays of 768 rows over nb * 8 / 2048 lanes,
    the literal flags (1 B a raster byte), three int64 pixel and three
    int64 sample arrays; the deposit, with six record arrays.  Each of
    some seventy buffers may take up to 1 MiB more in the allocator's
    rounding.  The mosaic's 512 MiB bucket counts 55.4 GB (the
    expansion); a stream as long as the raster 89 GB (the deposit), past
    the 80 GB card."""
    h, w, c = GLOBE
    total, px = h * (1 + w * c), h * w
    s, lanes, ST = SD.plan_chunks(nb)
    assert (s, ST) == (2048, 768) and lanes == nb * 8 // 2048
    rec = 4 * ST * lanes
    hand = 8 * nb + 2 * total + 48 * 8 * lanes + max(
        4 * rec + total + 3 * 8 * px + 3 * 8 * c * px, 6 * rec)
    got = SD.chunked_bytes(1, nb, h, w, c)
    assert hand <= got <= hand + (80 << 20)
    assert (got > 80 * 10 ** 9) == (nb == 1 << 30)


def test_globe_plan_on_an_80_gb_card():
    """On a card with 78 GB free: the globe's mosaic stream (362.7 MB,
    5.7 M lanes, a 512 MiB bucket) plans walk8 -> PK=1 (its PK=1 decode
    about 76 GB); a stream as long as its raster (10.9 M lanes, a 1 GiB
    bucket) plans walk8 alone, its PK=1 decode (about 143 GB) and its
    chunked decode (89 GB) never launched; the port's largest raster with
    such a stream (16.8 M lanes) still walks on walk8 (about 43 GB), one
    image a sub-batch."""
    h, w, c = GLOBE
    budget = 78 * 10 ** 9
    mosaic, raw = 362_711_534, h * (1 + w * c)
    assert TD.plan_tiers(1, 1 << 29, h, w, c, mosaic, budget) == \
        ("walk8_pk1", [(0, 1)])
    assert TD.plan_tiers(1, 1 << 30, h, w, c, raw, budget) == \
        ("walk8", [(0, 1)])
    assert TW.decode_bytes(1, TW.n_chunks(raw), TS.ST8, h, w * c) > \
        140 * 10 ** 9
    assert TW.fits(46601, 23040) and TW.n_chunks(46601 * 23041) > 16.7e6
    assert TD.plan_tiers(1, 1 << 31, 46601, 7680, 3, 46601 * 23041,
                         budget)[0] == "walk8"
    assert TD.plan_tiers(2, 1 << 31, 46601, 7680, 3, 46601 * 23041,
                         80 * 10 ** 9)[1] == [(0, 1), (1, 2)]
