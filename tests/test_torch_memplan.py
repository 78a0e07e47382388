"""The walk decode's memory plan and bounded epilogue against fpng_tpu, on
the CPU.

walk_offsets (ops/walk8.py) reads the walk's records a slab of _EPI_ROWS
rows at a time into int32 lane sums.  Its out0, steps and ovf are held
against fpng_tpu's epilogue - _decode_walk8 (walk8, lpi=8) and _decode_walk
(PK=1), Pallas in interpret mode, each run once per batch - and against
the unsliced epilogue this module keeps as its reference, at the default
slab and at one of 7 rows, which divides neither 96 nor 536.  A synthetic
record block with every row at outlen 511 pins the int32 lane sum and the
int64 prefix sum past 2^31.  Then the plan (models/decoder.py): its
sub-batches, and a split decode of six images that overflow walk8 in two
of three sub-batches, equal to fpng_tpu.decode_batch and to the unsplit
decode, directly and through decode_batch_sharded.  Tolerance zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fpng_tpu as F
import fpng_tpu_torch as T
from fpng_tpu.ops import specdec_tpu as JS
from fpng_tpu.ops import walk8 as JW
from fpng_tpu_torch import golden
from fpng_tpu_torch.models import decoder as TD
from fpng_tpu_torch.ops import specdec_tpu as TS
from fpng_tpu_torch.ops import walk8 as TW
from fpng_tpu_torch.parallel import mesh as TM
from fpng_tpu_torch.tools import decode_memory as DM
from fpng_tpu_torch.train import synthetic_corpus
from tests.test_torch_walk8 import _pack

# 4-channel 32 x 32 2-pass tiles; 4-7 overflow walk8 alone, 0-3 and 8-11
# do not
BATCHES = {("walk8", 1): [9], ("walk8", 3): [9, 0, 6],
           ("pk1", 1): [6], ("pk1", 3): [6, 9, 0]}
SPLIT = [9, 6, 0, 3, 8, 5]
# the 4-channel 256 x 256 tiles whose 1-pass stream overflows walk8 alone
OVERFLOWING_TILES = (4, 7)


def _tiles_png(idx):
    tiles = list(synthetic_corpus(4, size=32))
    imgs = np.stack([tiles[i] for i in idx])
    return imgs, [golden.encode_image_to_memory(i, 32, 32, 4,
                                                T.FPNG_ENCODE_SLOWER)
                  for i in imgs]


def _epilogue_unsliced(out, zlib_len, *, n_chunks):
    """walk_offsets' epilogue over the whole (B, ST, NC) record block at
    once, with int64 byte counts: the reference the slabs must equal."""
    e_fin, nst, ovf_l, posr, raw0, raw1, _ = out
    zl8 = zlib_len.to(torch.int64) * 8
    i32 = torch.int32
    ST = posr.shape[1]
    _, live, _ = TW._lane_geometry(zl8, n_chunks)
    stepi = torch.arange(ST, dtype=i32)[None, :, None]
    e3 = e_fin[:, None]
    recb = ((raw0 >> 9) & 1).bool() & live[:, None] & (stepi < nst[:, None])
    clen = (raw0 >> 19) & 15
    validr = recb & (posr >= e3)
    dem = recb & (raw1 != 0) & (posr < e3) & (posr + clen == e3)
    outl = ((raw0 >> 10) & 511).to(torch.int64)
    outb = (torch.where(validr, outl, 0) +
            torch.where(dem, outl - 1, 0)).sum(dim=1)
    outb = torch.where(live, outb, 0)
    out0 = torch.clamp(torch.cumsum(outb, dim=1) - outb, max=1 << 30)
    steps = torch.where(validr | dem, stepi + 1, 0).amax()
    ovf = (ovf_l & live).any(dim=1)
    return out0.to(i32), steps, ovf


def _jax_epilogue(tier, packed):
    """fpng_tpu's epilogue outputs: (out0 (B, nc_pad), steps, batch
    overflow) of _decode_walk8 (walk8) or _decode_walk (PK=1, which has no
    overflow)."""
    st, lut, p0, zl = (jnp.asarray(a) for a in packed)
    zmax = int(packed[3].max())
    if tier == "walk8":
        nc_pad, lpi = JW.plan_tpu8(zmax, 8)
        out = JW._decode_walk8(st, lut, p0, zl, nc_pad=nc_pad, lpi=lpi,
                               maxit=JW.MAXIT, interpret=True)
        d = int(out[6])
        return np.asarray(out[5]), d & ((1 << 30) - 1), bool(d >> 30)
    out = JS._decode_walk(st, lut, p0, zl, nc_pad=JS.plan_tpu(zmax),
                          interpret=True)
    return np.asarray(out[5]), int(np.asarray(out[6]).max()), False


@pytest.fixture(scope="module")
def epilogues():
    """Per (tier, B): the packed streams, the port's walk outputs and
    fpng_tpu's epilogue outputs, computed once."""
    res = {}
    for (tier, B), idx in BATCHES.items():
        packed = _pack(_tiles_png(idx)[1])
        args = [torch.from_numpy(a) for a in packed]
        nc = TW.n_chunks(int(packed[3].max()))
        walk = TW.walk_fix8 if tier == "walk8" else TS.walk_fix
        out = walk(TW.stream_words(args[0]), args[1], args[2],
                   (args[3] * 8).to(torch.int32), n_chunks=nc)
        res[tier, B] = packed, nc, out, _jax_epilogue(tier, packed)
    return res


@pytest.mark.parametrize("rows", [TW._EPI_ROWS, 7])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("tier", ["walk8", "pk1"])
def test_epilogue_matches_fpng_tpu_and_the_unsliced_one(
        epilogues, tier, B, rows, monkeypatch):
    monkeypatch.setattr(TW, "_EPI_ROWS", rows)
    packed, nc, out, (j_out0, j_steps, j_ovf) = epilogues[tier, B]
    args = [torch.from_numpy(a) for a in packed]
    records, e_fin, out0, steps, ovf, passes = TW.walk_offsets(
        lambda *a, **k: out, *args, n_chunks=nc)
    assert records[0] is out[3] and e_fin is out[0] and passes is out[6]
    want = _epilogue_unsliced(out, args[3], n_chunks=nc)
    for got, ref in zip((out0, steps, ovf), want):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert torch.equal(got, ref)
    assert bool(ovf.any()) == j_ovf == (6 in BATCHES[tier, B] and
                                        tier == "walk8")
    # walk8 stops an overflowing image early (only ovf is defined for it),
    # so offsets are held on the images that ran to convergence
    keep = [b for b, i in enumerate(BATCHES[tier, B])
            if tier == "pk1" or i != 6]
    live = np.arange(nc)[None] * 512 < packed[3][keep, None] * 8
    assert np.array_equal(np.where(live, out0.numpy()[keep], 0),
                          np.where(live, j_out0[keep, :nc], 0))
    if not j_ovf:
        assert int(steps) == j_steps


@pytest.mark.parametrize("rows", [TW._EPI_ROWS, 7])
def test_epilogue_lane_sums_at_outlen_511(rows, monkeypatch):
    """Every row of 536 recorded at outlen 511: each lane outputs 273 896
    bytes in int32, and the prefix sum over 8000 lanes passes 2^31 in
    int64 before the clamp at 2^30."""
    monkeypatch.setattr(TW, "_EPI_ROWS", rows)
    B, ST, NC = 1, TS.ST8, 8000
    i32 = torch.int32
    e_fin = (torch.arange(NC, dtype=i32) * 512)[None]
    posr = e_fin[:, None] + torch.arange(ST, dtype=i32)[None, :, None]
    raw0 = torch.full((B, ST, NC), 1 << 9 | 511 << 10 | 1 << 19, dtype=i32)
    out = (e_fin, torch.full((B, NC), ST, dtype=i32),
           torch.zeros((B, NC), dtype=torch.bool), posr, raw0,
           torch.zeros_like(raw0), torch.tensor(1, dtype=i32))
    zl = torch.tensor([NC * 64])
    args = (torch.zeros((B, 64), dtype=torch.uint8),
            torch.zeros((B, 4096), dtype=torch.int64),
            torch.zeros(B, dtype=torch.int64), zl)
    _, _, out0, steps, ovf, _ = TW.walk_offsets(lambda *a, **k: out, *args,
                                                n_chunks=NC)
    want = _epilogue_unsliced(out, zl, n_chunks=NC)
    for got, ref in zip((out0, steps, ovf), want):
        assert got.dtype == ref.dtype and torch.equal(got, ref)
    per_lane = ST * 511
    assert int(steps) == ST and not bool(ovf.any())
    assert int(out0[0, 1]) == per_lane and int(out0[0, -1]) == 1 << 30
    assert per_lane * NC > 1 << 31


@pytest.mark.parametrize("B,per,budget,out,want", [
    (5, 10, None, 1, [(0, 5)]),        # no budget (the CPU): one batch
    (5, 10, 50, 1, [(0, 5)]),          # the whole batch fits
    (5, 10, 5 + 20, 1, [(0, 2), (2, 4), (4, 5)]),
    (6, 10, 6 * 2 + 30, 2, [(0, 3), (3, 6)]),
    (4, 100, 50, 1, [(0, 1), (1, 2), (2, 3), (3, 4)]),  # one too large
    (1, 100, 50, 1, [(0, 1)]),
])
def test_plan_sub_batches(B, per, budget, out, want):
    def nbytes(b):
        return per * b

    parts = TD.plan_sub_batches(B, nbytes, budget, out)
    assert parts == want
    assert [a for a, _ in parts] == [0] + [b for _, b in parts[:-1]]
    assert parts[-1][1] == B and all(b > a for a, b in parts)
    if len(parts) > 1:
        assert all(b - a == 1 or nbytes(b - a) + B * out <= budget
                   for a, b in parts)


@pytest.fixture(scope="module")
def split_case():
    """SPLIT's files, fpng_tpu's decode and the port's unsplit one."""
    imgs, pngs = _tiles_png(SPLIT)
    stream, luts, p0, zl = TD.pack_streams([TD._parse_one(p) for p in pngs])
    args = tuple(torch.from_numpy(a) for a in (
        stream, luts.astype(np.int64), p0, zl))
    n0 = TD.decode_batch.sub_batches
    whole = TD.dispatch_kernel(*args, h=32, w=32, c=4, zmax=int(zl.max()))
    assert TD.decode_batch.sub_batches == n0 + 1 and whole[3] == "pk1"
    return imgs, pngs, args, int(zl.max()), F.decode_batch(pngs, 4), whole


def _statuses(ok):
    return [T.FPNG_DECODE_SUCCESS if o else T.FPNG_DECODE_NOT_FPNG
            for o in ok]


def test_split_decode_matches_fpng_tpu_and_the_unsplit_one(split_case):
    """A budget for two images a sub-batch: three sub-batches, the first
    and last of which overflow walk8 and decode on PK=1."""
    imgs, _, args, zmax, (f_sts, f_imgs), whole = split_case
    budget = TW.decode_bytes(2, TW.n_chunks(zmax), TS.ST8, 32, 128) + \
        len(SPLIT) * 32 * 128
    n0, o0 = TD.decode_batch.sub_batches, TD.decode_batch.walk8_overflows
    got, ok, overflow, path = TD.dispatch_kernel(
        *args, h=32, w=32, c=4, zmax=zmax, mem_budget=budget)
    assert TD.decode_batch.sub_batches - n0 == 3
    assert TD.decode_batch.walk8_overflows - o0 == 2 and path == "pk1"
    assert not overflow.any()
    assert _statuses(ok) == f_sts == [0] * len(SPLIT)
    assert torch.equal(got, whole[0]) and torch.equal(ok, whole[1])
    assert all(np.array_equal(a, b) for a, b in zip(got.numpy(), f_imgs))
    assert np.array_equal(got.numpy(), imgs)


def test_sharded_split_decode_matches_fpng_tpu(split_case, monkeypatch):
    """decode_batch_sharded over two CPU shards with a budget for one
    image's PK=1 decode a sub-batch and no more: every image is its own
    sub-batch.  (A budget under one image's PK=1 decode no longer launches
    it there: test_torch_globe.py holds the tiers.)"""
    imgs, pngs, args, _, (f_sts, f_imgs), whole = split_case
    zl, half = args[3], len(SPLIT) // 2
    ncs = [TW.n_chunks(int(zl[a:a + half].max())) for a in (0, half)]
    out = half * 32 * 128
    budget = max(TW.decode_bytes(1, n, TS.ST8, 32, 128) for n in ncs) + out
    assert all(TW.decode_bytes(2, n, TS.ST8, 32, 128) + out > budget
               for n in ncs)
    monkeypatch.setattr(TD, "_free_bytes", lambda device: budget)
    n0 = TD.decode_batch.sub_batches
    got, ok = TM.decode_batch_sharded(TM.make_mesh(["cpu", "cpu"]), pngs,
                                      32, 32, 4)
    assert TD.decode_batch.sub_batches - n0 == len(SPLIT)
    assert _statuses(ok) == f_sts
    assert np.array_equal(got, whole[0].numpy()) and np.array_equal(got,
                                                                    imgs)
    assert all(np.array_equal(a, b) for a, b in zip(got, f_imgs))


def test_case_b_mosaic_overflows_walk8():
    """chip_smoke.py's memory_plan case B: a 512 x 512 crop of its first
    frame, at the first cell that holds a tile whose stream overflows
    walk8 alone, overflows walk8 in a 1-pass mosaic too."""
    grid = DM.tile_grid(*DM.FRAME, 40, 0)
    r, q = np.argwhere(np.isin(grid, OVERFLOWING_TILES))[0]
    r, q = min(r, grid.shape[0] - 2), min(q, grid.shape[1] - 2)
    crop = DM.mosaic(*DM.FRAME, 4, 0)[256 * r:256 * r + 512,
                                      256 * q:256 * q + 512]
    packed = _pack(T.encode_batch(crop[None], 0, device="cpu"))
    args = [torch.from_numpy(a) for a in packed]
    ovf = TW.decode_walk8(*args, n_chunks=TW.n_chunks(int(packed[3].max())))[4]
    assert bool(ovf.all())


def test_model_counts_the_walk_records():
    """decode_bytes at the walk gate's edge: the finish holds five
    (B, ST, NC) int32 arrays (the records, meta and metb at k8 = ST), the
    raster and the image; an overflowing walk8 attempt (finish=False)
    holds no finalize, raster or image."""
    nc, h, bpl = 1085989, 5824, 23040
    rec = 4 * nc
    w8 = TW.decode_bytes(1, nc, 96, h, bpl)
    pk1 = TW.decode_bytes(1, nc, TS.ST8, h, bpl)
    attempt = TW.decode_bytes(1, nc, 96, h, bpl, finish=False)
    assert 5 * 96 * rec + 3 * h * bpl < w8 < 5 * 96 * rec + 4 * h * bpl
    assert 5 * TS.ST8 * rec + 3 * h * bpl < pk1 < 5 * TS.ST8 * rec + \
        4 * h * bpl
    assert 3 * 96 * rec < attempt < w8
    assert TW.decode_bytes(2, nc, 96, h, bpl) > 2 * w8 - (64 << 20)
