"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA device and skips without one (the CPU tests
hold the plain versions against fpng_tpu).  The file imports no JAX, so it
also runs where JAX is not installed, without tests/conftest.py:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import functools
import zlib

import numpy as np
import pytest
import torch

import fpng_tpu_torch as T
from fpng_tpu_torch import golden
from fpng_tpu_torch.models.decoder import (_parse_one, decode_batch,
                                           pack_streams)
from fpng_tpu_torch.models.encoder import (_budget, _num_words, build_desc,
                                           tokens)
from fpng_tpu_torch.ops import specdec_tpu as PK
from fpng_tpu_torch.ops import walk8 as W
from fpng_tpu_torch.ops.assemble import (idat_crc_words, idat_crc_words_plain,
                                         raw_idat_prefix)
from fpng_tpu_torch.ops import checksum as TC
from fpng_tpu_torch.ops.bitpack import (deposit_bits, scatter_bits,
                                        scatter_packed16,
                                        scatter_packed16_plain)
from fpng_tpu_torch.ops.encfuse import (demote_mask, demote_mask_plain,
                                        encode_bits_fused, encode_bits_plain,
                                        pack_table)
from fpng_tpu_torch.ops.expand import expand, expand_plain
from fpng_tpu_torch.tables import one_pass_state
from fpng_tpu_torch.tools import prof_depparts as TP1
from fpng_tpu_torch.tools import prof_int8mxu as TP2
from fpng_tpu_torch.train import synthetic_corpus

pytestmark = pytest.mark.usefixtures("cuda_device")


@pytest.fixture
def rng():
    return np.random.default_rng(0xC0DA)


def make_test_image(rng, h, w, c, kind):
    """Noise, with flat bands and columns unless kind == "noise"."""
    img = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    if kind != "noise" and h >= 4 and w >= 4:
        img[h // 4:h // 2, :] = rng.integers(0, 256, c, dtype=np.uint8)
        img[:, w // 4:w // 3] = rng.integers(0, 256, c, dtype=np.uint8)
    if kind == "flat":
        img[h // 2:] = img[:1, :1]
    return img


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _desc(imgs, device):
    B = imgs.shape[0]
    st = one_pass_state(3, device)
    desc, tbl, *_ = build_desc(
        torch.from_numpy(imgs).to(device), st.codes.expand(B, -1),
        st.sizes.expand(B, -1),
        torch.full((B,), st.acc, device=device),
        torch.full((B,), st.nacc, device=device), num_chans=3,
        cost_check=False)
    base = torch.full((B,), len(st.prefix) * 8, dtype=torch.int32,
                      device=device)
    return desc, tbl, base


@pytest.mark.parametrize("shape,nw_cut,zero_tiles", [
    ((2, 13, 29), 0, False), ((3, 64, 64), 0, False), ((1, 1, 1), 0, False),
    ((2, 127, 31), 0, False), ((2, 100, 200), 0, False),
    ((2, 100, 200), 3000, False), ((2, 40, 700), 0, True),
    ((1, 2160, 3840), 0, False)])
def test_encfuse_matches_plain(rng, shape, nw_cut, zero_tiles):
    """B1 against its plain version, one launch a call; zero_tiles clears
    units [4096, 12288) of each stream, two whole tiles of zero-width units
    between tiles that share words."""
    B, H, W = shape
    imgs = np.stack([make_test_image(rng, H, W, 3, k)
                     for k in ("mixed", "flat", "noise")[:B]])
    dev = torch.device("cuda")
    desc, tbl, base = _desc(imgs, dev)
    if zero_tiles:
        desc[:, 4096:12288] = 0
    nw = nw_cut or _num_words(_budget(H, W, 3))  # nw_cut drops words
    n0 = encode_bits_fused.launches
    got = encode_bits_fused(desc, tbl, base, nw)
    torch.cuda.synchronize()
    assert encode_bits_fused.launches == n0 + 1
    want = encode_bits_plain(desc.cpu(), tbl.cpu(), base.cpu(), nw)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_encfuse_saturates_like_plain(rng):
    """B1's int64 bit offsets past 2^31: total_bits and last_tok are the
    plain version's exact int64 counts, no longer saturated at 2^31 - 1,
    and no unit lands in the words."""
    imgs = np.stack([make_test_image(rng, 20, 30, 3, k)
                     for k in ("mixed", "noise")])
    dev = torch.device("cuda")
    desc, tbl, base = _desc(imgs, dev)
    base = torch.full_like(base, 2 ** 31 - 100)
    got = encode_bits_fused(desc, tbl, base, 1024)
    want = encode_bits_plain(desc.cpu(), tbl.cpu(), base.cpu(), 1024)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert (got[1] > 2 ** 31 - 1).all() and not got[0].any()


# (chunks K, payload end bytes per image as a function of N = 4 * NW,
# prefix lengths; None = one prefix shared by the batch, as 1-pass)
IDAT_CASES = [
    (49, lambda N: [N - 777, 3 * 4096 + 5, 40 * 4096], None),
    (1, lambda N: [61, 4096, 2000], [10, 0, 33]),
    (3, lambda N: [N, N, N - 1], [40, 2, 17]),
    (3, lambda N: [4095, 200, 65], [20, 20, 64]),
    (2, lambda N: [N - 4, 9, 4097], [0, 0, 0]),
    (4, lambda N: [N - 2, 2 * 4096, 7000], [300, 5, 1]),
]


@pytest.mark.parametrize("case", range(len(IDAT_CASES)))
def test_idat_crc_kernel_matches_plain_and_zlib(case):
    """B2 in one launch against idat_crc_words_plain (torch ops on the
    card) and zlib: an odd chunk count, one
    chunk, no zero tail, a payload inside the first chunk, no prefix,
    per-image prefixes."""
    K, tb_of, plens = IDAT_CASES[case]
    rng = np.random.default_rng(case)
    B, NW = 3, K * 1024
    words = rng.integers(0, 2**32, (B, NW), np.uint64).astype(np.uint32)
    if plens is None:
        prefixes = [bytes(rng.integers(0, 256, 37, np.uint8))] * B
    else:
        prefixes = [bytes(rng.integers(0, 256, n, np.uint8)) for n in plens]
    tb = np.array(tb_of(4 * NW), np.int64)
    adler = rng.integers(0, 2**32, B, np.uint64).astype(np.int64)
    plens = np.array([len(p) for p in prefixes], np.int64)
    raw_ip = raw_idat_prefix(prefixes).astype(np.int64)
    wt = torch.from_numpy(words.view(np.int32)).cuda()
    tbits = torch.from_numpy(tb * 8).to(torch.int32).cuda()
    at = torch.from_numpy(adler).cuda()
    n0 = idat_crc_words.launches
    got = idat_crc_words(wt, tbits, at, plens, raw_ip)
    torch.cuda.synchronize()
    assert idat_crc_words.launches == n0 + 1
    want = idat_crc_words_plain(wt, tbits, at, torch.from_numpy(plens).cuda(),
                                torch.from_numpy(raw_ip).cuda())
    assert torch.equal(got, want)
    for b in range(B):
        raw = bytearray(words[b].tobytes()[:tb[b]])
        raw[:len(prefixes[b])] = prefixes[b]
        msg = b"IDAT" + bytes(raw) + int(adler[b]).to_bytes(4, "big")
        assert int(got[b]) == zlib.crc32(msg), b


@pytest.mark.parametrize("n,total,nw_cut,shift", [
    (6000, 50000, 0, 4), (70000, 30000, 0, 4), (5000, 40000, 500, 4),
    (6000, 50000, 0, 0)])
def test_deposit_matches_scatter(n, total, nw_cut, shift):
    rng = np.random.default_rng(n)
    B = 3
    # decode-style records: sorted slots, literals at distinct slots,
    # zero-width records at repeated ones
    step = rng.random((B, n)) < 0.3
    outp = np.minimum(np.cumsum(step, axis=1), total)
    lit = step & (rng.random((B, n)) < 0.8)
    vals = np.where(lit, rng.integers(0, 256, (B, n)) | 0x100, 0)
    nbits = np.where(lit, 16, 0)
    # slots with shift 4 (as the chunked decode), or bit offsets
    offs = torch.from_numpy((outp << (4 - shift)).astype(np.int32))
    nw = nw_cut or (16 * (total + 1)) // 32 + 2
    args = [torch.from_numpy(a.astype(np.int32)) for a in (vals, nbits)]
    n0 = deposit_bits.launches
    got = deposit_bits(*[a.cuda() for a in args], offs.cuda(), nw,
                       shift=shift)
    assert deposit_bits.launches == n0 + 1
    assert torch.equal(got.cpu(), scatter_bits(
        *args, torch.from_numpy(outp * 16), nw))


def test_deposit_places_units_past_2_31_bits():
    """B10's 64-bit bit offsets: int32 slots (shift 4) straddling 2^27 (bit
    2^31) of a raster past 2^27 bytes, each literal in its own 16-bit
    slot."""
    base = 2 ** 27 - 3
    slots = torch.tensor([[5, base, base + 1, base + 3, base + 3, base + 6]],
                         dtype=torch.int32)
    syms = torch.tensor([[0x141, 0x17F, 0x100, 0x1AA, 0, 0x1FF]],
                        dtype=torch.int32)
    num_words = (base + 8) // 2
    got = deposit_bits(syms.cuda(), (syms != 0).to(torch.int32).cuda() << 4,
                       slots.cuda(), num_words, shift=4)
    half = got.cpu().numpy().view(np.uint16)[0]
    want = {int(s): int(v) for s, v in zip(slots[0], syms[0]) if v}
    assert {int(i): int(half[i]) for i in np.flatnonzero(half)} == want


def test_kernel_wrappers_reject_wrong_dtype():
    x = torch.zeros((1, 8), dtype=torch.int64, device="cuda")
    with pytest.raises(ValueError):
        deposit_bits(x, x, x, 4)


def test_roundtrip_on_card_matches_cpu(rng):
    imgs = np.stack([make_test_image(rng, 40, 100, 3, k)
                     for k in ("mixed", "flat", "noise")])
    gpu = T.encode_batch(imgs, 0, device="cuda")
    cpu = T.encode_batch(imgs, 0, device="cpu")
    assert gpu == cpu
    sts, outs = T.decode_batch(gpu, 3, device="cuda")
    assert sts == [0, 0, 0]
    assert all(np.array_equal(o, i) for o, i in zip(outs, imgs))


def _walk_inputs(case):
    """Packed streams: 3-channel 1-pass, 4-channel 2-pass (per-image
    tables), and a 256 x 256 stream of ~2 600 chunks (many blocks)."""
    if case == "rgb_1pass":
        tiles = list(synthetic_corpus(3, size=48))
        imgs = np.stack([tiles[0], tiles[9], tiles[20]])
        pngs = T.encode_batch(imgs, 0, device="cpu")
    elif case == "rgba_2pass":
        tiles = list(synthetic_corpus(4, size=40))
        imgs = np.stack([tiles[9], tiles[0], tiles[30]])
        pngs = [golden.encode_image_to_memory(i, 40, 40, 4,
                                              T.FPNG_ENCODE_SLOWER)
                for i in imgs]
    else:
        imgs = list(synthetic_corpus(3, size=256))[18][None]
        pngs = T.encode_batch(imgs, 0, device="cpu")
    metas = [_parse_one(p) for p in pngs]
    assert all(m[7] is not None for m in metas)
    return imgs, [torch.from_numpy(a.astype(t)) for a, t in zip(
        pack_streams(metas), (np.uint8, np.int32, np.int32, np.int32))]


@pytest.mark.parametrize("case", ["rgb_1pass", "rgba_2pass", "multiblock"])
def test_walk8_kernels_match_plain(case):
    imgs, (stream, luts, p0, zl) = _walk_inputs(case)
    B, h, w, c = imgs.shape
    nc = W.n_chunks(int(zl.max()))
    words = W.stream_words(stream)
    zl8 = zl * 8
    n0 = W.walk_fix8.launches
    got = W.walk_fix8(words.cuda(), luts.cuda(), p0.cuda(), zl8.cuda(),
                      n_chunks=nc)
    torch.cuda.synchronize()
    want = W.walk_fix8_plain(words, luts, p0, zl8, n_chunks=nc)
    # one launch for the whole walk; the pass count stays on the card
    assert W.walk_fix8.launches == n0 + 1
    assert int(got[6]) == int(want[6]) > 1
    for g, w_ in zip(got[:3], want[:3]):  # e_fin, nst, ovf
        assert torch.equal(g.cpu(), w_)
    if case == "multiblock":
        assert nc > 2 * 128
    rows = torch.arange(got[3].shape[1])[None, :, None] < want[1][:, None]
    for g, w_ in zip(got[3:6], want[3:6]):  # records, up to each lane's nst
        assert torch.equal(torch.where(rows, g.cpu(), 0),
                           torch.where(rows, w_, 0))

    e_fin, nst = got[0], got[1]
    posr, raw0, raw1 = got[3:6]
    out0 = torch.arange(nc, dtype=torch.int32, device="cuda")[None] \
        .expand(B, nc).contiguous() * 37  # any offsets exercise B4
    for k8 in (8, 48, posr.shape[1]):
        kw = dict(k8=k8, h=h, bpl=w * c, c=c)
        gk = W.finalize_records8(posr, raw0, raw1, nst, e_fin, out0, **kw)
        wk = W.finalize_records8_plain(posr.cpu(), raw0.cpu(), raw1.cpu(),
                                       nst.cpu(), e_fin.cpu(), out0.cpu(),
                                       **kw)
        for g, w_ in zip(gk, wk):
            assert torch.equal(g.cpu(), w_)

    got, ok, seed = W.decode_kernel8(stream.cuda(), luts.cuda(), p0.cuda(),
                                     zl.cuda(), h=h, w=w, c=c,
                                     zlib_len_max=int(zl.max()))
    assert seed is None and bool(ok.all())
    assert np.array_equal(got.cpu().numpy(), imgs)


@pytest.mark.parametrize("c,h,w", [
    (3, 13, 7), (4, 9, 70), (3, 300, 517), (4, 1, 1), (3, 21, 13),
    (3, 256, 256),     # the headline: 16 bands of 16 rows
    (3, 40, 3840),     # 4K rows: 3 strips of 3840, bands of 3 rows
    (4, 7, 3840),      # 4K RGBA rows: 4 strips
    (3, 3, 1500),      # strips whose rows are not 16-byte aligned
    (3, 2, 60000)])    # one row cut into 44 strips
def test_expand_matches_plain(c, h, w):
    rng = np.random.default_rng(c * h + w)
    B = 3
    raster = torch.from_numpy(
        rng.integers(-(1 << 15), 1 << 15, (B, h * w * c)).astype(np.int16))
    raster[torch.from_numpy(rng.random((B, h * w * c)) < 0.5)] &= ~0x100
    n0 = expand.launches
    got = expand(raster.cuda(), h=h, w=w, c=c)
    torch.cuda.synchronize()
    assert expand.launches == n0 + 1
    assert torch.equal(got.cpu(), expand_plain(raster, h=h, w=w, c=c))


@pytest.mark.parametrize("n,n_slots", [(5000, 9000), (70000, 150000)])
def test_scatter_packed16_matches_plain(n, n_slots):
    rng = np.random.default_rng(n)
    B = 3
    # distinct slots, at most one record per slot pair, some out of range
    slots = np.sort(rng.choice(n_slots // 2 + 8, (B, n)), axis=1) * 2 - 4
    kind = rng.integers(0, 3, (B, n))
    v = rng.integers(0, 256, (B, n, 2))
    metb = np.where(kind > 0, 0x100 | v[..., 0], 0) | \
        np.where(kind == 2, (0x100 | v[..., 1]) << 16, 0)
    first = np.concatenate([np.ones((B, 1), bool),
                            slots[:, 1:] != slots[:, :-1]], axis=1)
    metb = np.where(first, metb, 0)
    meta, metb = (torch.from_numpy(a.astype(np.int32)) for a in (slots, metb))
    n0 = scatter_packed16.launches
    got = scatter_packed16(meta.cuda(), metb.cuda(), n_slots)
    torch.cuda.synchronize()
    assert scatter_packed16.launches == n0 + 1
    assert torch.equal(got.cpu(), scatter_packed16_plain(meta, metb, n_slots))


def test_decode_batch_takes_walk8_on_card():
    tiles = list(synthetic_corpus(3, size=64))
    imgs = np.stack(tiles[:12])
    pngs = T.encode_batch(imgs, 0, device="cuda")
    counters = (W.walk_fix8, W.finalize_records8, scatter_packed16, expand)
    before = [f.launches for f in counters]
    sts, outs = T.decode_batch(pngs, 3, device="cuda")
    assert sts == [0] * len(imgs)
    assert all(np.array_equal(o, i) for o, i in zip(outs, imgs))
    assert all(f.launches > n for f, n in zip(counters, before))


@pytest.mark.parametrize("shape", [(3, 40, 100), (2, 1, 1), (1, 300, 517),
                                   (3, 21, 13)])
def test_demote_mask_matches_plain(shape):
    """B7 on 4-channel images over a 2-value alphabet (many 1-pixel match
    starts), with the 1-pass tables, random code sizes and a table where
    every candidate ties (fpng's strict > keeps those as matches)."""
    B, H, W_ = shape
    rng = np.random.default_rng(H * W_)
    imgs = (rng.integers(0, 2, (B, H, W_, 4)) * 37).astype(np.uint8)
    st = one_pass_state(4, "cuda")
    codes, sizes = st.codes.expand(B, -1), st.sizes.expand(B, -1).clone()
    sizes[0] = torch.from_numpy(rng.integers(1, 13, 288)).cuda()
    if B > 1:  # every 1-pixel match ties with its literals: 7 + 1 = 4 x 2
        sizes[1] = 2
        sizes[1, 258] = 7
    deltas, _, mstart, mlen, _, ls, le = tokens(torch.from_numpy(imgs).cuda(),
                                                4)
    args = (deltas, ls, le, mstart & (mlen == 1), pack_table(codes, sizes))
    n0 = demote_mask.launches
    got = demote_mask(*args)
    torch.cuda.synchronize()
    assert demote_mask.launches == n0 + 1
    assert torch.equal(got.cpu(), demote_mask_plain(*(a.cpu() for a in args)))


def _overflowing_batch():
    """Two 2-pass 32 x 32 x 4 tiles; the first overflows walk8."""
    tiles = list(synthetic_corpus(4, size=32))
    imgs = np.stack([tiles[6], tiles[9]])
    pngs = [golden.encode_image_to_memory(i, 32, 32, 4, T.FPNG_ENCODE_SLOWER)
            for i in imgs]
    metas = [_parse_one(p) for p in pngs]
    return imgs, pngs, [torch.from_numpy(a.astype(t)) for a, t in zip(
        pack_streams(metas), (np.uint8, np.int32, np.int32, np.int32))]


def _walk_equal(got, want):
    """A walk's outputs on the card equal the plain version's: e_fin, nst,
    ovf and passes, and the records up to each lane's nst."""
    assert int(got[6]) == int(want[6])
    for g, w_ in zip(got[:3], want[:3]):  # e_fin, nst, ovf
        assert torch.equal(g.cpu(), w_)
    rows = torch.arange(got[3].shape[1])[None, :, None] < want[1][:, None]
    for g, w_ in zip(got[3:6], want[3:6]):
        assert torch.equal(torch.where(rows, g.cpu(), 0),
                           torch.where(rows, w_, 0))


def test_walk8_stops_an_overflowing_image_beside_a_converging_one():
    """B3 on the batch whose image 0 overflows walk8: the kernel's
    overflowing lanes walk on past their rows, unrecorded, as the plain
    version's do, so every output of both images is the plain version's
    (same overflow flags, same passes), and the converged entries and
    passes are B8's."""
    _, _, (stream, luts, p0, zl) = _overflowing_batch()
    nc = W.n_chunks(int(zl.max()))
    words, zl8 = W.stream_words(stream), zl * 8
    n0 = W.walk_fix8.launches
    got = W.walk_fix8(words.cuda(), luts.cuda(), p0.cuda(), zl8.cuda(),
                      n_chunks=nc)
    torch.cuda.synchronize()
    assert W.walk_fix8.launches == n0 + 1
    want = W.walk_fix8_plain(words, luts, p0, zl8, n_chunks=nc)
    live = W._lane_geometry(zl8, nc)[1]
    assert (want[2] & live).any(dim=1).tolist() == [True, False]
    _walk_equal(got, want)
    b8 = PK.walk_fix_plain(words, luts, p0, zl8, n_chunks=nc)
    assert torch.equal(got[0].cpu(), b8[0]) and int(got[6]) == int(b8[6])


@pytest.mark.parametrize("maxit", [2, W.MAXIT])
def test_walk8_unrecorded_tail_matches_plain(maxit):
    """B3's walk past its rows on the card, against the plain version: at
    maxit = 2 (16 rows) most lanes of the 2-pass tiles walk on unrecorded,
    and their exits decide the fixpoint."""
    _, _, (stream, luts, p0, zl) = _overflowing_batch()
    nc = W.n_chunks(int(zl.max()))
    args = (W.stream_words(stream), luts, p0, zl * 8)
    got = W.walk_fix8(*(a.cuda() for a in args), n_chunks=nc, maxit=maxit)
    want = W.walk_fix8_plain(*args, n_chunks=nc, maxit=maxit)
    assert bool(want[2].any())
    _walk_equal(got, want)


def test_seeded_pk1_walk_matches_plain():
    """B8 seeded with B3's converged entries (resume_seed), on the card:
    the plain version's outputs, 2 passes, the unseeded B8's entries, and
    the seed's own memory as its entries."""
    _, _, (stream, luts, p0, zl) = _overflowing_batch()
    nc = W.n_chunks(int(zl.max()))
    args = (W.stream_words(stream), luts, p0, zl * 8)
    cargs = [a.cuda() for a in args]
    b3 = W.walk_fix8(*cargs, n_chunks=nc)
    seed = W.resume_seed(*b3[3:6], b3[1], b3[0])
    want = PK.walk_fix_plain(*args, n_chunks=nc, seed=seed.cpu())
    n0 = PK.walk_fix.launches
    got = PK.walk_fix(*cargs, n_chunks=nc, seed=seed)
    torch.cuda.synchronize()
    assert PK.walk_fix.launches == n0 + 1
    assert got[0] is seed
    _walk_equal(got, want)
    assert int(got[6]) == 2
    assert torch.equal(got[0], PK.walk_fix(*cargs, n_chunks=nc)[0])


def test_pk1_kernels_match_plain():
    imgs, _, (stream, luts, p0, zl) = _overflowing_batch()
    B, h, w, c = imgs.shape
    nc = W.n_chunks(int(zl.max()))
    got8, _, seed = W.decode_kernel8(
        stream.cuda(), luts.cuda(), p0.cuda(), zl.cuda(), h=h, w=w, c=c,
        zlib_len_max=int(zl.max()))
    assert got8 is None and seed is not None  # overflow: its entries
    words, zl8 = W.stream_words(stream), zl * 8
    n0 = PK.walk_fix.launches
    got = PK.walk_fix(words.cuda(), luts.cuda(), p0.cuda(), zl8.cuda(),
                      n_chunks=nc)
    torch.cuda.synchronize()
    want = PK.walk_fix_plain(words, luts, p0, zl8, n_chunks=nc)
    assert PK.walk_fix.launches == n0 + 1
    assert int(got[6]) == int(want[6]) > 1
    assert got[3].shape[1] == PK.ST8
    for g, w_ in zip(got[:3], want[:3]):  # e_fin, nst, ovf
        assert torch.equal(g.cpu(), w_)
    assert int(want[1].max()) > 8 * W.MAXIT  # deeper than walk8's rows
    rows = torch.arange(PK.ST8)[None, :, None] < want[1][:, None]
    for g, w_ in zip(got[3:6], want[3:6]):
        assert torch.equal(torch.where(rows, g.cpu(), 0),
                           torch.where(rows, w_, 0))

    e_fin, nst = got[0], got[1]
    posr, raw0, raw1 = got[3:6]
    out0 = torch.arange(nc, dtype=torch.int32, device="cuda")[None] \
        .expand(B, nc).contiguous() * 41
    n0 = PK.finalize_records.launches
    for k8 in (8, 112, PK.ST8):
        kw = dict(k8=k8, h=h, bpl=w * c, c=c)
        gk = PK.finalize_records(posr, raw0, raw1, nst, e_fin, out0, **kw)
        wk = PK.finalize_records_plain(posr.cpu(), raw0.cpu(), raw1.cpu(),
                                       nst.cpu(), e_fin.cpu(), out0.cpu(),
                                       **kw)
        for g, w_ in zip(gk, wk):
            assert torch.equal(g.cpu(), w_)
    assert PK.finalize_records.launches == n0 + 3

    di, ok = PK.decode_kernel_pk1(stream.cuda(), luts.cuda(), p0.cuda(),
                                  zl.cuda(), h=h, w=w, c=c,
                                  zlib_len_max=int(zl.max()))
    assert bool(ok.all()) and np.array_equal(di.cpu().numpy(), imgs)


@pytest.mark.parametrize("c,flags", [(4, 0), (3, T.FPNG_ENCODE_SLOWER),
                                     (4, T.FPNG_ENCODE_SLOWER)])
def test_mode_roundtrip_on_card_matches_cpu(rng, c, flags):
    """32 bpp 1-pass (B7 launches) and 2-pass: the card's bytes equal the
    CPU run's, and decode_batch gives the images back."""
    tiles = list(synthetic_corpus(c, size=64))
    imgs = np.stack([tiles[k] for k in (0, 6, 9, 20)] +
                    [make_test_image(rng, 64, 64, c, "noise")])
    n0 = demote_mask.launches
    gpu = T.encode_batch(imgs, flags, device="cuda")
    assert demote_mask.launches == n0 + (c == 4 and not flags)
    assert gpu == T.encode_batch(imgs, flags, device="cpu")
    sts, outs = T.decode_batch(gpu, c, device="cuda")
    assert sts == [0] * len(imgs)
    assert all(np.array_equal(o, i) for o, i in zip(outs, imgs))


@pytest.mark.parametrize("mode", TP1.ALL_MODES)
@pytest.mark.parametrize("m", [8, 12])
def test_depparts_matches_plain(mode, m):
    """P1 at B = 3, T = 2, WPS = 2: the kernel's last step against the
    plain version, every mode; cu includes negative slot words."""
    cu, big, ohc0 = TP1.inputs(3, 2, 2, m, seed=m, device="cpu")
    cu[:, :, ::7] = -cu[:, :, ::7] - 1
    n0 = TP1.depparts.launches
    got = TP1.depparts(cu.cuda(), big.cuda(), ohc0.cuda(), mode)
    torch.cuda.synchronize()
    assert TP1.depparts.launches == n0 + 1
    assert torch.equal(got.cpu(), TP1.depparts_plain(cu, big, ohc0, mode))


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_int8_mxu_matches_plain(dtype):
    """P2 at K = 256, reps = 3, T = 2: a reaches past 256, so the int8
    cast wraps and the bf16 cast rounds."""
    rng = np.random.default_rng(9)
    a = torch.from_numpy(rng.integers(0, 1000, (128, 256)).astype(np.int32))
    b = torch.from_numpy(rng.integers(0, 2, (256, 128)).astype(np.int32))
    n0 = TP2.int8_mxu.launches
    got = TP2.int8_mxu(a.cuda(), b.cuda(), dtype=dtype, reps=3, T=2)
    torch.cuda.synchronize()
    assert TP2.int8_mxu.launches == n0 + 1
    assert torch.equal(got.cpu(), TP2.int8_mxu_plain(a, b, dtype=dtype,
                                                     reps=3))


def test_walk8_overflow_decodes_on_pk1_on_card():
    imgs, pngs, _ = _overflowing_batch()
    from fpng_tpu_torch.models.decoder import decode_batch

    n0, k0 = decode_batch.walk8_overflows, decode_batch.paths["pk1"]
    b0 = PK.walk_fix.launches, PK.finalize_records.launches
    sts, outs = T.decode_batch(pngs, 4, device="cuda")
    assert sts == [0, 0]
    assert all(np.array_equal(o, i) for o, i in zip(outs, imgs))
    assert decode_batch.walk8_overflows == n0 + 1
    assert decode_batch.paths["pk1"] == k0 + 1
    assert PK.walk_fix.launches > b0[0]
    assert PK.finalize_records.launches == b0[1] + 1


def _finalize_cases():
    """Real walk8 records (the 256 x 256 multi-block stream, ST = 96) and
    PK=1 records (the 2-pass tiles whose first overflows walk8, ST = 536),
    with the offsets and entries of the decode's own epilogue."""
    _, (stream, luts, p0, zl) = _walk_inputs("multiblock")
    nc = W.n_chunks(int(zl.max()))
    args = (stream.cuda(), luts.cuda(), p0.cuda(), zl.cuda())
    records, e_fin, out0, *_ = W.decode_walk8(*args, n_chunks=nc)
    yield "walk8", W.finalize_records8, (*records, e_fin, out0), \
        (256, 256, 3)
    _, _, (stream, luts, p0, zl) = _overflowing_batch()
    nc = W.n_chunks(int(zl.max()))
    args = (stream.cuda(), luts.cuda(), p0.cuda(), zl.cuda())
    records, e_fin, out0, *_ = W.walk_offsets(PK.walk_fix, *args,
                                              n_chunks=nc)
    yield "pk1", PK.finalize_records, (*records, e_fin, out0), (32, 32, 4)


def test_finalize_tiles_match_plain():
    """B4 and B9 at k8 in {1, 17, 96, 536} (up to each walk's rows) on real
    records, with the lane count cut to one that is not a multiple of the
    kernel's 32-lane tile: meta, metb and chk equal the plain version's,
    and one profiled call copies nothing from the host."""
    from torch.profiler import ProfilerActivity, profile

    for name, fn, full, (h, w, c) in _finalize_cases():
        NC = full[0].shape[2]
        cut = NC - 5 if NC % 32 == 0 else NC
        args = [a[..., :cut].contiguous() for a in full]
        assert cut % 32 != 0
        for k8 in (1, 17, 96, 536):
            if k8 > args[0].shape[1]:
                continue
            kw = dict(k8=k8, h=h, bpl=w * c, c=c)
            n0 = fn.launches
            got = fn(*args, **kw)
            torch.cuda.synchronize()
            assert fn.launches == n0 + 1
            want = W.finalize_records8_plain(*(a.cpu() for a in args), **kw)
            for g, w_ in zip(got, want):
                assert torch.equal(g.cpu(), w_), (name, k8)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn(*args, **kw)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()]
        assert any("finalize8" in n for n in names), names
        assert not [n for n in names if "HtoD" in n], names


def _p2_operands(K, dtype, seed):
    """int8: a in [0, 1000), b in [-300, 300), so both casts wrap; bf16: a
    in [0, 300), so a + r rounds, and b in {-1, 0, 1}, so every partial
    sum stays below 2^24 at K = 4096, reps = 8 and the float32 sums are
    exact."""
    rng = np.random.default_rng(seed)
    if dtype == torch.int8:
        a = rng.integers(0, 1000, (128, K))
        b = rng.integers(-300, 300, (K, 128))
    else:
        a = rng.integers(0, 300, (128, K))
        b = rng.integers(-1, 2, (K, 128))
    return (torch.from_numpy(a.astype(np.int32)),
            torch.from_numpy(b.astype(np.int32)))


@pytest.mark.parametrize("reps", [0, 1, 3, 8])
@pytest.mark.parametrize("K", [32, 256, 4096])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_int8_mxu_every_slot_matches_plain(dtype, K, reps):
    """P2 at T in {1, 2, 65}: every one of the T output slots equals the
    plain product, and the public wrapper returns slot T - 1."""
    a, b = _p2_operands(K, dtype, seed=K + reps)
    want = TP2.int8_mxu_plain(a, b, dtype=dtype, reps=reps)
    ac, bc = a.cuda(), b.cuda()
    for Tn in (1, 2, 65):
        n0 = TP2.int8_mxu.launches
        slots = TP2._int8_mxu_slots(ac, bc, dtype=dtype, reps=reps, T=Tn)
        torch.cuda.synchronize()
        assert TP2.int8_mxu.launches == n0 + 1
        assert slots.shape == (Tn, 128, 128)
        assert all(torch.equal(s.cpu(), want) for s in slots), Tn
        assert torch.equal(TP2.int8_mxu(ac, bc, dtype=dtype, reps=reps,
                                        T=Tn).cpu(), want)


@pytest.mark.parametrize("mode", TP1.ALL_MODES)
@pytest.mark.parametrize("m", [8, 12])
def test_depparts_every_slot_matches_plain(mode, m):
    """P1 at T in {1, 3, 18} and WPS in {1, 4}: every one of the T output
    slots equals the plain version on that step (so no step's products
    can be skipped unseen), cu with negative slot words; the scratch is
    the staged layout's size."""
    for Tn in (1, 3, 18):
        for wps in (1, 4):
            cu, big, ohc0 = TP1.inputs(2, Tn, wps, m, seed=Tn + wps,
                                       device="cpu")
            cu[:, :, ::7] = -cu[:, :, ::7] - 1
            n0 = TP1.depparts.launches
            slots = TP1._depparts_slots(cu.cuda(), big.cuda(), ohc0.cuda(),
                                        mode)
            torch.cuda.synchronize()
            assert TP1.depparts.launches == n0 + 1
            assert slots.shape == (2, Tn, 8, 128)
            for t in range(Tn):
                want = TP1.depparts_plain(cu[:, t:t + 1], big, ohc0, mode)
                assert torch.equal(slots[:, t].cpu(), want), (Tn, wps, t)
            src, prod = TP1._ROUTES[mode]
            nks = 4096 // (16 if prod == 2 else 32)
            assert TP1._scratch_bytes(2, wps, src, prod) == (
                0 if prod == 0 else 2 * nks * 1024 * (1 + 4 * src))


def test_scatter_packed16_tiles_on_real_records():
    """B5 on real walk8 and PK=1 records from the finalize at k8 in {1, 17,
    96, 536} (up to each walk's rows), with a lane count that is not a
    multiple of the kernel's 64-lane tile: in the (B, k8, NC) form and
    flattened to (B, N), the raster equals the plain version's."""
    for name, fn, full, (h, w, c) in _finalize_cases():
        NC = full[0].shape[2]
        cut = NC - 5 if NC % 32 == 0 else NC
        args = [a[..., :cut].contiguous() for a in full]
        n_slots = h * w * c
        for k8 in (1, 17, 96, 536):
            if k8 > args[0].shape[1]:
                continue
            meta, metb, _ = fn(*args, k8=k8, h=h, bpl=w * c, c=c)
            want = scatter_packed16_plain(meta.cpu(), metb.cpu(), n_slots)
            B = meta.shape[0]
            for m_, v_ in ((meta, metb),
                           (meta.reshape(B, -1), metb.reshape(B, -1))):
                n0 = scatter_packed16.launches
                got = scatter_packed16(m_, v_, n_slots)
                torch.cuda.synchronize()
                assert scatter_packed16.launches == n0 + 1
                assert torch.equal(got.cpu(), want), (name, k8, m_.dim())


@pytest.mark.parametrize("n", [1, 2])
def test_mesh_on_card_matches_one_batch(n):
    """The sharded calls over n entries of cuda:0 against the single-batch
    calls: bytes, pixels, the fused and the stepped histograms, and B1 and
    B3 once a shard."""
    from fpng_tpu_torch.models.encoder import encode_kernel, hist_kernel
    from fpng_tpu_torch.parallel import mesh as M

    mesh = M.make_mesh(["cuda:0"] * n)
    imgs = np.stack(list(synthetic_corpus(3, size=64))[:8])
    want = T.encode_batch(imgs, 0, device="cuda")
    b1, b3 = encode_bits_fused.launches, W.walk_fix8.launches
    got = M.encode_batch_sharded(mesh, imgs, 0)
    assert got == want and encode_bits_fused.launches == b1 + n
    keep = [j for j, p in enumerate(want) if _parse_one(p)[7] is not None]
    keep = keep[:len(keep) - len(keep) % n]
    dec, ok = M.decode_batch_sharded(mesh, [want[j] for j in keep], 64, 64, 3)
    assert ok.all() and np.array_equal(dec, imgs[keep])
    assert W.walk_fix8.launches == b3 + n
    dev = torch.from_numpy(imgs).cuda()
    hist = hist_kernel(dev, num_chans=3).sum(0)
    assert torch.equal(M.training_step(mesh, imgs, 3), hist)
    words, bits, adler, ghist = M.full_step_sharded(mesh, imgs, 3)
    st = one_pass_state(3, "cuda")
    col = functools.partial(torch.full, (8,), dtype=torch.int32,
                            device="cuda")
    ref = encode_kernel(dev, st.codes.expand(8, -1), st.sizes.expand(8, -1),
                        col(len(st.prefix) * 8), col(st.acc), col(st.nacc),
                        num_chans=3, cost_check=False, want_hist=True,
                        num_words=words.shape[1])
    for a, b in zip((words, bits, adler), ref[:2] + ref[3:4]):
        assert torch.equal(a, b)
    assert torch.equal(ghist, ref[4].sum(0)) and torch.equal(ghist, hist)


def test_dryrun_multichip_on_every_card():
    from fpng_tpu_torch import graft_entry

    graft_entry.dryrun_multichip(torch.cuda.device_count(), device="cuda")
    fn, args = graft_entry.entry()
    assert fn(*args)[4].shape == (2, 288)


@pytest.mark.parametrize("n", [1, 257, 4096, 70001, 1 << 20])
def test_crc32_bytes_on_card_matches_zlib(n):
    """The byte-array CRC (torch ops, no kernel) on CUDA tensors: every
    row, and ragged lengths (0 and n among them) with the tails zeroed."""
    rng = np.random.default_rng(n)
    lens = np.array([0, n, *rng.integers(0, n + 1, 2)], np.int32)
    data = rng.integers(0, 256, (len(lens), n), dtype=np.uint8)
    got = TC.crc32_bytes(torch.from_numpy(data).cuda())
    assert got.is_cuda
    assert [int(g) for g in got] == [zlib.crc32(r.tobytes()) for r in data]
    data[np.arange(n)[None, :] >= lens[:, None]] = 0
    got = TC.crc32_bytes_var(torch.from_numpy(data).cuda(),
                             torch.from_numpy(lens).cuda())
    assert [int(g) for g in got] == [zlib.crc32(r[:k].tobytes())
                                     for r, k in zip(data, lens)]


SHAPES = [  # tests/test_fuzz_shapes.py's
    (1, 1), (1, 8193), (8193, 1), (2, 4097), (4096, 2), (3, 2731),
    (1, 257), (513, 1),
]
SHAPE_CASES = [(h, w, ch, flags) for h, w in SHAPES for ch in (3, 4)
               for flags in (0, T.FPNG_ENCODE_SLOWER)] + \
    [(1, 8193, 3, T.FPNG_FORCE_UNCOMPRESSED)]


@pytest.mark.parametrize("h,w,ch,flags", SHAPE_CASES)
def test_extreme_shape_on_card_matches_cpu(h, w, ch, flags, monkeypatch):
    """tests/test_torch_shapes.py's cases on the card: the PNG bytes equal
    the CPU run's, and the card decodes them on the CPU run's path."""
    img = np.random.default_rng([h, w, ch]).integers(0, 256, (h, w, ch),
                                                     dtype=np.uint8)
    img[:max(1, h // 2)] = img[0, 0]
    png = T.encode_batch(img[None], flags, device="cuda")[0]
    assert png == T.encode_batch(img[None], flags, device="cpu")[0]
    paths = []
    for dev in ("cuda", "cpu"):
        monkeypatch.setattr(decode_batch, "paths",
                            {"walk8": 0, "pk1": 0, "chunked": 0})
        sts, outs = T.decode_batch([png], ch, device=dev)
        assert sts == [0] and np.array_equal(outs[0], img), dev
        paths.append(dict(decode_batch.paths))
    assert paths[0] == paths[1]


@pytest.mark.parametrize("kind", ["real3", "real4"])
def test_decode_memory_model_and_split_on_card(kind):
    """The walk decode's byte model (ops/walk8.decode_bytes) against the
    dispatch's measured peak on a small walk8 batch (32 tiles of 256 x 256
    x 3, 1-pass) and a small PK=1 batch (32 x 4 channels, 1-pass, whose
    tiles 4 and 7 overflow walk8): at least the peak and at most 1.5
    times it.  Then a budget for half the batch splits it into two
    sub-batches with the same pixels."""
    from fpng_tpu_torch import bench
    from fpng_tpu_torch.models.decoder import dispatch_kernel
    from fpng_tpu_torch.tools.profile_kernels import decode_inputs

    imgs = bench.make_corpus(kind, B=32)
    _, h, w, c = imgs.shape
    args, kept = decode_inputs(T.encode_batch(imgs, device="cuda"), imgs,
                               "cuda")
    n, zmax = len(kept), int(args[3].max())
    nc, kw = W.n_chunks(zmax), dict(h=h, w=w, c=c, zmax=zmax)
    o0 = decode_batch.walk8_overflows
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    whole = dispatch_kernel(*args, **kw)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - start
    overflowed = decode_batch.walk8_overflows - o0
    assert (whole[3], overflowed) == (("pk1", 1) if kind == "real4" else
                                      ("walk8", 0))
    model = W.decode_bytes(n, nc, 8 * W.MAXIT, h, w * c,
                           finish=not overflowed)
    if overflowed:
        model = max(model, W.decode_bytes(n, nc, PK.ST8, h, w * c))
    assert peak <= model <= 1.5 * peak
    assert bool(whole[1].all()) and \
        np.array_equal(whole[0].cpu().numpy(), kept)
    budget = W.decode_bytes(-(-n // 2), nc, PK.ST8, h, w * c) + n * h * w * c
    s0 = decode_batch.sub_batches
    split = dispatch_kernel(*args, **kw, mem_budget=budget)
    assert decode_batch.sub_batches - s0 == 2 and split[3] == whole[3]
    assert torch.equal(split[0], whole[0]) and torch.equal(split[1], whole[1])


@pytest.mark.parametrize("case", ["rgb_1pass", "multiblock"])
def test_wide_walk8_kernels_match_plain(case, monkeypatch):
    """B3 and B4 at 64-bit positions (the kernels' instance for streams of
    2^31 bits or more, forced here by lowering ops/walk8.POS32_BITS)
    against their plain versions, and the decode against the raster."""
    monkeypatch.setattr(W, "POS32_BITS", 0)
    imgs, (stream, luts, p0, zl) = _walk_inputs(case)
    B, h, w, c = imgs.shape
    nc = W.n_chunks(int(zl.max()))
    i64 = torch.int64
    args = (W.stream_words(stream), luts, p0.to(i64), zl.to(i64) * 8)
    got = W.walk_fix8(*[a.cuda() for a in args], n_chunks=nc)
    torch.cuda.synchronize()
    want = W.walk_fix8_plain(*args, n_chunks=nc)
    assert got[0].dtype == got[3].dtype == want[3].dtype == i64
    _walk_equal(got, want)
    e_fin, nst = got[0], got[1]
    out0 = torch.arange(nc, dtype=torch.int32, device="cuda")[None] \
        .expand(B, nc).contiguous() * 37
    for k8 in (8, got[3].shape[1]):
        kw = dict(k8=k8, h=h, bpl=w * c, c=c)
        gk = W.finalize_records8(*got[3:6], nst, e_fin, out0, **kw)
        wk = W.finalize_records8_plain(*(t.cpu() for t in got[3:6]),
                                       nst.cpu(), e_fin.cpu(), out0.cpu(),
                                       **kw)
        assert gk[2].dtype == i64
        for g, w_ in zip(gk, wk):
            assert torch.equal(g.cpu(), w_)
    img, ok, seed = W.decode_kernel8(stream.cuda(), luts.cuda(), p0.cuda(),
                                     zl.cuda(), h=h, w=w, c=c,
                                     zlib_len_max=int(zl.max()))
    assert seed is None and bool(ok.all())
    assert np.array_equal(img.cpu().numpy(), imgs)


def test_wide_pk1_resumes_and_decodes_on_card(monkeypatch):
    """walk8 -> PK=1 at 64-bit positions: the seeded B8 against its plain
    version (2 passes), B9's check triple with int64's "no position", and
    decode_batch's pixels."""
    monkeypatch.setattr(W, "POS32_BITS", 0)
    imgs, pngs, (stream, luts, p0, zl) = _overflowing_batch()
    nc = W.n_chunks(int(zl.max()))
    i64 = torch.int64
    args = (W.stream_words(stream), luts, p0.to(i64), zl.to(i64) * 8)
    cargs = [a.cuda() for a in args]
    b3 = W.walk_fix8(*cargs, n_chunks=nc)
    seed = W.resume_seed(*b3[3:6], b3[1], b3[0])
    assert seed.dtype == i64
    want = PK.walk_fix_plain(*args, n_chunks=nc, seed=seed.cpu())
    got = PK.walk_fix(*cargs, n_chunks=nc, seed=seed)
    _walk_equal(got, want)
    assert int(got[6]) == 2
    sts, outs = T.decode_batch(pngs, 4, device="cuda")
    assert sts == [0, 0]
    assert all(np.array_equal(o, i) for o, i in zip(outs, imgs))


def test_wide_encoder_counts_on_card(rng):
    """B1's int64 total_bits and last_tok against its plain version, read
    by B2, and the files equal the CPU's."""
    imgs = np.stack([make_test_image(rng, 40, 70, 3, k)
                     for k in ("mixed", "flat")])
    want_files = T.encode_batch(imgs, 0, device="cpu")
    dev = torch.device("cuda")
    desc, tbl, base = _desc(imgs, dev)
    nw = _num_words(_budget(40, 70, 3))
    got = encode_bits_fused(desc, tbl, base, nw)
    want = encode_bits_plain(desc.cpu(), tbl.cpu(), base.cpu(), nw)
    assert got[1].dtype == got[2].dtype == torch.int64
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert T.encode_batch(imgs, 0, device="cuda") == want_files
