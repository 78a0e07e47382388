"""walk8 decode: the default device decode (counterpart of
fpng_tpu/ops/walk8.py).

The reference decodes its single deflate block with a sequential 12-bit
table loop (fpng.cpp:2209-2901).  Here the stream is cut into S = 512-bit
chunks and one lane walks each chunk:

  B3 walk_fix8          from every chunk boundary, walk tokens with the
                        packed LUT (one step = one token, or two literals
                        when the LUT packs a second one), recording each
                        step's position, sym/outlen/clen/flags word and
                        second literal, then on unrecorded to the chunk
                        end; then iterate the chunk entries to a fixpoint
                        (entry[c] = exit[c-1], entry[0] = p0), re-walking
                        only lanes whose corrected entry is not among their
                        recorded positions
  epilogue (torch)      per-lane output byte counts from the records past
                        each lane's converged entry, their exclusive prefix
                        sum (out0), the step trim and the overflow flag,
                        read back once
  B4 finalize_records8  mask each lane's pre-convergence prefix, demote
                        split pairs, emit one deposit record per step and
                        run fpng's constraint checks (fpng.cpp:2257-2584),
                        reduced to per-image fail / eob_end / bad_end
  B5 scatter_packed16   literal deposit into a zeroed 16-bit-slot raster
                        (ops/bitpack.py)
  B6 expand             per-row match fill, Up defilter, pixel bytes
                        (ops/expand.py)

Each lane has 8 * maxit step slots (ST = 96).  A stream that needs more
steps than that in one chunk (under ~5.3 bits a step) sets the overflow
flag.  The lane still walks on to its chunk end without recording (up to
CAP steps, the PK=1 walk's rows), so every exit is exact and B3 reaches
the PK=1 walk's fixpoint; on an overflow decode_kernel8 returns those
converged entries (resume_seed), and the caller decodes the batch on the
PK=1 walk (ops/specdec_tpu.py), which runs the same kernels at worst-case
capacity from them (2 passes), through walk_cuda, walk_offsets,
finalize_cuda and finish_decode.  The whole walk is one launch; the host
reads nothing back until the epilogue's single readback.

Records are step-major, (B, ST, NC): lane c's step j sits at [b, j, c], so
the lanes of a warp read and write neighbouring words.  Bit positions (p0,
the stream end, entries, exits, the position records and the finalize's
eob_end and bad_end) are int32 for streams under 2^31 bits and int64 past
them (pos_dtype): a stream of 268 MB or more, as a whole-globe raster's,
walks with 64-bit positions, and every other walk holds what it held.  The
Pallas kernels' PK=8 sublane packing, select-chain word windows,
lpi/gchunk geometry, narrow 23-bit records and 256-slot row padding are
TPU layout and are not carried over.

Every kernel wrapper takes its plain torch version for a CPU tensor and
launches its CUDA kernel (csrc/walk8.cu, csrc/finalize8.cu) for a CUDA
tensor, or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import kernels as K
from ..utils import trace
from .bitpack import MASK32, scatter_packed16
from .expand import _scratch_bytes, expand, tiling

S = 512           # chunk bits
MAXIT = 12        # step slots per lane: ST = 8 * maxit (as fpng_tpu's)
_MEMB = 32        # fixpoint membership window, in steps (as fpng_tpu's)
CAP = S + 24      # steps a walk takes at most: one a bit, plus the token
                  # tail (the PK=1 walk's rows, ops/specdec_tpu.ST8)
INF = 0x7FFFFFFF  # "no position" of an int32 check triple
# bit positions are int32 below this many bits a stream, else int64
POS32_BITS = 1 << 31
# record rows the epilogue reads at a time: two slabs on walk8, whose
# temporaries (337 B a lane) stay under one 96-row int32 array (384)
_EPI_ROWS = 48


def fits(h: int, bpl: int) -> bool:
    """The walk path's raster limit, the port's own: h * (bpl + 1) < 2^30,
    the int32 output offsets of B4 (out0 and the running offset, clamped at
    2^30 by walk_offsets).  fpng_tpu's walk gate (H8 * bpl_pad < 2^27, from
    the TPU's VMEM budget) is not the port's: a raster up to 1 073 M bytes,
    as the 10800 x 21600 x 3 whole-globe raster (699.85 M bytes), decodes
    on walk8.  The decode dispatch and the walk finalizes (B4, B9) take the
    limit from here; past it the chunked decode takes a raster up to 2^31
    bytes.  The limit bounds one image: whether its walk fits the card is
    the memory plan's question (models/decoder.dispatch_kernel,
    decode_bytes), asked before anything launches."""
    return h * (bpl + 1) < 1 << 30


def pos_dtype(n_chunks: int) -> torch.dtype:
    """The dtype of a walk's bit positions over n_chunks lanes: int32
    while every position, up to the last lane's end and its token tail,
    stays under POS32_BITS (2^31 bits: streams under 268 MB), else int64."""
    return torch.int32 if (n_chunks + 1) * S < POS32_BITS else torch.int64


def n_chunks(zlib_len_max: int) -> int:
    """Walk lanes for streams of at most zlib_len_max bytes."""
    return max(1, -(-zlib_len_max * 8 // S))


def stream_words(stream: torch.Tensor) -> torch.Tensor:
    """(B, Nb) uint8 -> (B, ceil(Nb/4)) int32 little-endian words."""
    pad = -stream.shape[1] % 4
    if pad:
        stream = torch.nn.functional.pad(stream, (0, pad))
    return stream.contiguous().view(torch.int32)


# ---------------------------------------------------------------------------
# B3: walk + entry fixpoint
# ---------------------------------------------------------------------------


def _lane_geometry(zl8: torch.Tensor, NC: int):
    bit0 = (torch.arange(NC, dtype=torch.int64, device=zl8.device) * S)[None]
    z = zl8.to(torch.int64)[:, None]
    return bit0, bit0 < z, torch.minimum(bit0 + S, z)


def _walk_plain(words64, lut64, ent, bound, act, posr, raw0, raw1,
                cap: int = CAP):
    """Walk every lane with `act` set from `ent` until it reaches `bound`,
    stops on an invalid code, or has taken `cap` steps.  Writes the rows of
    its first ST steps (ST = posr.shape[1]); returns (exit, rows written,
    overflow: the walk did not fit its ST rows)."""
    ST = posr.shape[1]
    nw = words64.shape[1] - 2
    pos = ent.clone()
    n = torch.zeros_like(ent)
    for j in range(cap):
        if not bool(act.any()):
            break
        wi = torch.clamp(pos >> 5, max=nw)
        sh = pos & 31
        w = ((torch.gather(words64, 1, wi) >> sh) |
             (torch.gather(words64, 1, wi + 1) << (32 - sh))) & MASK32
        e = torch.gather(lut64, 1, w & 0xFFF)
        sym = e & 511
        clen = (e >> 9) & 15
        nextra = (e >> 13) & 7
        is_m = (sym > 256) & (sym <= 285)
        stop = clen == 0
        l2 = (e >> 25) & 15
        two = (sym < 256) & ~stop & (l2 > 0)
        if j < ST:
            extra = (w >> clen) & ((1 << nextra) - 1)
            run = ((e >> 16) & 0x1FF) + extra
            outlen = torch.where(sym < 256, 1, torch.where(is_m, run, 0)) + \
                two.to(torch.int64)
            r0 = (sym | (~stop).to(torch.int64) << 9 | outlen << 10 |
                  clen << 19 | is_m.to(torch.int64) << 23)
            r1 = torch.where(two, ((e >> 16) & 0xFF) | 0x100, 0)
            posr[:, j] = torch.where(act, pos, posr[:, j])
            raw0[:, j] = torch.where(act, r0, raw0[:, j])
            raw1[:, j] = torch.where(act, r1, raw1[:, j])
        n += act.to(torch.int64)
        adv = act & ~stop
        tok = clen + torch.where(is_m, nextra + 1, 0) + \
            torch.where(two, l2, 0)
        pos = torch.where(adv, pos + tok, pos)
        act = adv & (pos < bound)
    return pos, torch.clamp(n, max=ST), (n > ST) | act


def fixpoint_plain(words, lut, p0, zl8, *, n_chunks: int, ST: int,
                   seed=None):
    """The walk and fixpoint of kernels B3 and B8 in torch ops, with ST step
    rows a lane: walk_fix8's seven outputs.  seed (B, NC) int32, when
    given, is resume_seed's: pass 0 walks each lane from its entry, or from
    p where the seed is ~p, and the seed is the walk's entry buffer (it is
    returned as e_fin).  Without it each lane starts at its chunk boundary,
    lane 0 at p0."""
    B = words.shape[0]
    NC = n_chunks
    dev = words.device
    words64 = torch.nn.functional.pad(words.to(torch.int64) & MASK32, (0, 2))
    lut64 = lut.to(torch.int64) & MASK32
    p0 = p0.to(torch.int64)[:, None]
    bit0, live, bound = _lane_geometry(zl8, NC)
    # step-major int64 records: each step's row stays contiguous
    posr, raw0, raw1 = (torch.zeros((B, ST, NC), dtype=torch.int64,
                                    device=dev) for _ in range(3))
    if seed is None:
        ent = bit0.expand(B, NC).clone()
        ent[:, :1] = p0
        start = ent
    else:
        s = seed.to(torch.int64)
        start = torch.where(s < 0, ~s, s)
    ex, nst, ovf = _walk_plain(words64, lut64, start, bound,
                               live & (start < bound), posr, raw0, raw1)
    if seed is not None:  # ~p: the entry is the second literal of row 0
        ent = torch.where(s < 0, start + ((raw0[:, 0] >> 19) & 15), s)
    passes = 1
    M = min(_MEMB, ST)
    rows = torch.arange(M, device=dev)[None, :, None]
    for _ in range(NC + 1):
        passes += 1
        e_new = torch.cat([p0, ex[:, :-1]], dim=1)
        chg = (e_new != ent) & live
        if not bool(chg.any()):
            break
        en = e_new[:, None]
        pr = posr[:, :M]
        hit = (pr == en) | \
            ((raw1[:, :M] != 0) & (pr + ((raw0[:, :M] >> 19) & 15) == en))
        member = (hit & (rows < nst[:, None])).any(dim=1)
        ent = torch.where(chg, e_new, ent)
        wm = chg & ~member
        ex2, nst2, ovf2 = _walk_plain(words64, lut64, ent, bound,
                                      wm & (ent < bound), posr, raw0, raw1)
        ex = torch.where(wm, ex2, ex)
        nst = torch.where(wm, nst2, nst)
        ovf = torch.where(wm, ovf2, ovf)
    i32, pdt = torch.int32, pos_dtype(NC)
    e_fin = ent.to(pdt) if seed is None else seed.copy_(ent)
    return (e_fin, nst.to(i32), ovf, posr.to(pdt), raw0.to(i32),
            raw1.to(i32), torch.tensor(passes, dtype=i32, device=dev))


def walk_fix8_plain(words, lut, p0, zl8, *, n_chunks: int,
                    maxit: int = MAXIT):
    """Plain torch version of kernel B3 (same contract as walk_fix8)."""
    return fixpoint_plain(words, lut, p0, zl8, n_chunks=n_chunks,
                          ST=8 * maxit)


def walk_fix8(words, lut, p0, zl8, *, n_chunks: int, maxit: int = MAXIT):
    """Kernel B3: walk + entry fixpoint over n_chunks 512-bit lanes.

    words (B, NW) int32 LE stream words (reads past NW are zero); lut
    (B, 4096) int32 packed LUTs (ops/specdec.pack_lut); p0 (B,) first
    token bit; zl8 (B,) stream end bit (8 * zlib_len).  Returns (e_fin,
    nst, ovf, posr, raw0, raw1, passes): per-lane converged entry, steps
    recorded and overflow flag (B, NC); step-major records (B, ST, NC)
    int32 - rows at or past a lane's nst are unspecified; and the number
    of walk passes as a 0-dim int32 tensor on the input's device (pass 0
    plus every fixpoint pass, the last of which finds no change).  The bit
    positions - p0, zl8, e_fin and posr - are of pos_dtype(n_chunks).

    A lane that overflows its rows walks on unrecorded (up to CAP steps),
    so its exit is exact: every image runs to the fixpoint of the PK=1
    walk (ops/specdec_tpu.walk_fix), in the same passes and to the same
    converged entries; only an overflowing lane's records are cut short.

    A CUDA tensor launches csrc/walk8.cu once for the whole walk; nothing
    is read back.  `walk_fix8.launches` counts the launches and
    `walk_fix8.passes` the passes that decode_kernel8 reads back.
    """
    if words.device.type == "cpu":
        return walk_fix8_plain(words, lut, p0, zl8, n_chunks=n_chunks,
                               maxit=maxit)
    out = walk_cuda("walk_fix8", words, lut, p0, zl8, n_chunks=n_chunks,
                    ST=8 * maxit)
    walk_fix8.launches += 1
    return out


walk_fix8.launches = 0
walk_fix8.passes = 0


def walk_cuda(name: str, words, lut, p0, zl8, *, n_chunks: int, ST: int,
              seed=None):
    """Run csrc/walk8.cu's walk and fixpoint with ST <= CAP step rows a
    lane, in one cooperative launch (walk_fix8's contract), at the kernel's
    32-bit or 64-bit positions (pos_dtype).  seed (B, NC) of positions,
    contiguous, when given, is resume_seed's and the walk's entry
    buffer: the walk reads its seeds from it, writes its entries into it
    and returns it as e_fin, so a resumed walk holds no more than a fresh
    one.  The launch's grid, blocks per SM and shared-memory LUT slots are
    left in `walk_cuda.launch`."""
    NC = n_chunks
    pdt = pos_dtype(NC)
    K.require_cuda(name, words, lut)
    K.require_cuda(name, p0, zl8, *(() if seed is None else (seed,)),
                   dtype=pdt)
    B, nw = words.shape
    if lut.shape != (B, 4096) or p0.shape != (B,) or zl8.shape != (B,):
        raise ValueError(f"{name}: lut (B, 4096), p0 and zl8 (B,)")
    if seed is not None and seed.shape != (B, NC):
        raise ValueError(f"{name}: seed (B, n_chunks)")
    if not 0 < ST <= CAP:
        raise ValueError(f"{name}: ST outside (0, {CAP}]")
    dev, i32 = words.device, torch.int32
    posr = torch.empty((B, ST, NC), dtype=pdt, device=dev)
    raw0, raw1 = (torch.empty((B, ST, NC), dtype=i32, device=dev)
                  for _ in range(2))
    nst, ovf = (torch.empty((B, NC), dtype=i32, device=dev)
                for _ in range(2))
    ex0, ex1 = (torch.empty((B, NC), dtype=pdt, device=dev)
                for _ in range(2))
    ent = torch.empty_like(ex0) if seed is None else seed
    ctl = torch.zeros(4, dtype=torch.int32, device=dev)  # flags, passes
    info = (ctypes.c_int * 3)()
    K.check(K.lib().fpng_walk8(
        words.data_ptr(), nw, lut.data_ptr(), p0.data_ptr(), zl8.data_ptr(),
        B, NC, ST, int(seed is not None), int(pdt == torch.int64),
        ent.data_ptr(), ex0.data_ptr(),
        ex1.data_ptr(), nst.data_ptr(), ovf.data_ptr(), posr.data_ptr(),
        raw0.data_ptr(), raw1.data_ptr(), ctl.data_ptr(),
        ctypes.addressof(info), K.stream_ptr(dev)), "fpng_walk8")
    walk_cuda.launch = dict(zip(("grid", "blocks_per_sm", "lut_slots"), info))
    return ent, nst, ovf != 0, posr, raw0, raw1, ctl[3]


walk_cuda.launch = None


def resume_seed(posr, raw0, raw1, nst, e_fin):
    """The seed of a walk that resumes from a converged one (B, NC), of
    e_fin's dtype: each lane's converged entry, or ~p where that entry is
    the second literal of a literal pair its last walk recorded at p.  A
    walk from such an entry would pair the literals after it otherwise and
    could exit a literal away from the converged exit; from p it retraces
    the last walk.  The pair lies within the membership window (_MEMB
    rows), read _MEMB // 4 rows at a time."""
    seed = e_fin.clone()
    e3, n3 = e_fin[:, None], nst[:, None]
    M = min(_MEMB, posr.shape[1])
    R = _MEMB // 4
    for j in range(0, M, R):
        p = posr[:, j:j + R]
        rows = torch.arange(j, j + p.shape[1], device=p.device)[:, None]
        pair = (raw1[:, j:j + R] != 0) & (rows < n3) & \
            (((raw0[:, j:j + R] >> 19) & 15) + p == e3)
        torch.where(pair.any(dim=1),
                    torch.sum(p * pair, dim=1, dtype=p.dtype)
                    .bitwise_not_(), seed, out=seed)
    return seed


# ---------------------------------------------------------------------------
# epilogue: output offsets, step trim, overflow (torch, both devices)
# ---------------------------------------------------------------------------


def decode_walk8(stream, lut, p0, zlib_len, *, n_chunks: int,
                 maxit: int = MAXIT):
    """Stage 1: walk + fixpoint + epilogue.

    stream (B, Nb) uint8 zlib payloads, zero padded; lut (B, 4096) packed
    LUTs; p0 (B,) first token bit; zlib_len (B,) IDAT byte lengths.
    Returns (records, e_fin, out0, steps, ovf, passes) with records =
    (posr, raw0, raw1, nst): out0 (B, NC) int32 per-lane output offsets
    (exclusive prefix sum of the bytes each lane decodes past its
    converged entry), steps (scalar tensor) the highest step any lane
    needs, ovf (B,) bool per-image capacity overflow.
    """
    return walk_offsets(functools.partial(walk_fix8, maxit=maxit), stream,
                        lut, p0, zlib_len, n_chunks=n_chunks)


def walk_offsets(walk, stream, lut, p0, zlib_len, *, n_chunks: int):
    """decode_walk8's contract with the walk `walk` (walk_fix8, or the
    PK=1 walk of ops/specdec_tpu.py): the walk, then the epilogue in torch
    ops on either device (_lane_sums; only the prefix sum across lanes is
    int64), the bit positions of pos_dtype(n_chunks)."""
    zl8 = zlib_len.to(torch.int64) * 8
    i32, pdt = torch.int32, pos_dtype(n_chunks)
    e_fin, nst, ovf_l, posr, raw0, raw1, passes = walk(
        stream_words(stream), lut.to(i32).contiguous(), p0.to(pdt),
        zl8.to(pdt), n_chunks=n_chunks)
    live = _lane_geometry(zl8, n_chunks)[1]
    outb, last = _lane_sums(posr, raw0, raw1, nst, e_fin)
    outb *= live
    last *= live
    # int64 sum, clamped: every offset past 2^30 lies past any raster the
    # walk path takes, and the clamp keeps B4's int32 carries from wrapping
    out0 = torch.clamp(torch.cumsum(outb, dim=1, dtype=torch.int64) - outb,
                       max=1 << 30)
    ovf = (ovf_l & live).any(dim=1)
    return (posr, raw0, raw1, nst), e_fin, out0.to(i32), last.amax(), ovf, \
        passes


def _lane_sums(posr, raw0, raw1, nst, e_fin):
    """Each lane's output bytes past its converged entry and its last kept
    step, (B, NC) int32 each (at most 536 rows of outlen <= 511: under
    2^19), from the (B, ST, NC) records read _EPI_ROWS rows at a time.
    Its temporaries - one slab of _EPI_ROWS rows and one lane array of the
    positions' dtype, and three bool slabs - are allocated once, written in
    place and freed on return (decode_bytes counts them)."""
    B, ST, NC = posr.shape
    dev, i32 = posr.device, torch.int32
    e3, n3 = e_fin[:, None], nst[:, None]
    step1 = torch.arange(1, ST + 1, dtype=i32, device=dev)[:, None]
    outb = torch.zeros((B, NC), dtype=i32, device=dev)
    last = torch.zeros_like(outb)
    part = torch.empty((B, NC), dtype=posr.dtype, device=dev)
    R = min(_EPI_ROWS, ST)
    x = torch.empty((B, R, NC), dtype=posr.dtype, device=dev)
    keep, ge, t = (torch.empty((B, R, NC), dtype=torch.bool, device=dev)
                   for _ in range(3))
    for j in range(0, ST, R):
        r = min(R, ST - j)
        p, r0, step = posr[:, j:j + r], raw0[:, j:j + r], step1[j:j + r]
        xs, ks, gs, ts = x[:, :r], keep[:, :r], ge[:, :r], t[:, :r]
        # keep: a token the lane recorded (bit 9, a step below nst) at or
        # past its converged entry, or a literal pair whose second literal
        # starts at the entry (dem: it outputs one byte less)
        torch.bitwise_right_shift(r0, 19, out=xs)
        xs &= 15
        xs += p
        torch.eq(xs, e3, out=ks)
        torch.ne(raw1[:, j:j + r], 0, out=ts)
        ks &= ts
        torch.ge(p, e3, out=gs)
        ks |= gs
        torch.bitwise_and(r0, 512, out=xs)
        torch.ne(xs, 0, out=ts)
        ks &= ts
        torch.le(step, n3, out=ts)
        ks &= ts
        torch.bitwise_right_shift(r0, 10, out=xs)
        xs &= 511
        xs *= ks
        outb += torch.sum(xs, dim=1, dtype=part.dtype, out=part)
        gs.logical_not_()
        gs &= ks
        xs.copy_(gs)
        outb -= torch.sum(xs, dim=1, dtype=part.dtype, out=part)
        torch.mul(ks, step, out=xs)
        torch.maximum(last, torch.amax(xs, dim=1, out=part), out=last)
    return outb, last


def trim_steps(steps: int, ST: int) -> int:
    """The record rows B4 reads: steps rounded up to 16 (at least 8)."""
    return min(-(-steps // 16) * 16 if steps > 8 else 8, ST)


# ---------------------------------------------------------------------------
# B4: finalize records + constraint checks
# ---------------------------------------------------------------------------


def finalize_records8_plain(posr, raw0, raw1, nst, e_fin, out0, *, k8: int,
                            h: int, bpl: int, c: int):
    """Plain torch version of kernel B4 (same contract as
    finalize_records8)."""
    B, _, NC = posr.shape
    dev = posr.device
    i64 = torch.int64
    inf = torch.iinfo(posr.dtype).max
    rs = bpl + 1
    total = h * rs
    n_slots = h * bpl
    carry = out0.to(i64)
    e_l = e_fin.to(i64)
    meta = torch.empty((B, k8, NC), dtype=torch.int32, device=dev)
    metb = torch.empty_like(meta)
    fail = torch.zeros((B, NC), dtype=torch.bool, device=dev)
    eobm = torch.full((B, NC), inf, dtype=i64, device=dev)
    badm = eobm.clone()
    for j in range(k8):
        p = posr[:, j].to(i64)
        r0 = raw0[:, j].to(i64)
        r1 = raw1[:, j].to(i64)
        recbit = (((r0 >> 9) & 1) == 1) & (j < nst)
        clen = (r0 >> 19) & 15
        is_m = ((r0 >> 23) & 1) == 1
        s2 = r1 & 0xFF
        dem = recbit & (r1 != 0) & (p < e_l) & (p + clen == e_l)
        rec = (recbit & (p >= e_l)) | dem
        sym = torch.where(dem, s2, r0 & 511)
        outlen = torch.where(dem, 1, (r0 >> 10) & 511)
        two = rec & (r1 != 0) & ~dem
        outp = carry
        carry = carry + torch.where(rec, outlen, 0)

        q = outp // rs
        rowpos = outp - q * rs
        rowpos2 = torch.where(rowpos + 1 == rs, 0, rowpos + 1)
        lit = rec & (sym < 256) & (rowpos != 0) & (outp < total)
        lit2 = two & (rowpos2 != 0) & (outp + 1 < total)
        lit2_only = lit2 & ~lit
        off = torch.where(lit2_only, q * bpl + rowpos2 - 1,
                          q * bpl + rowpos - 1)
        meta[:, j] = torch.clamp(off, 0, n_slots).to(torch.int32)
        val = torch.where(lit | lit2_only, torch.where(lit, sym, s2) | 0x100,
                          0) | torch.where(lit & lit2, (s2 | 0x100) << 16, 0)
        metb[:, j] = val.to(torch.int32)

        lv = rec & (outp < total)
        x = rowpos - 1
        f = lv & (sym > 285)
        fexp = torch.where(outp >= rs, 2, 0)
        f |= lv & (rowpos == 0) & ((sym >= 256) | (sym != fexp))
        mok = (rowpos >= 1) & (x % c == 0) & (outlen % c == 0) & \
            (x + outlen <= bpl)
        f |= lv & is_m & ~mok
        f |= lv & (rowpos >= 1) & (x % c != 0) & (sym >= 256)
        f |= lv & (sym == 256)
        at_total = rec & (outp == total)
        eobm = torch.minimum(eobm, torch.where(at_total & (sym == 256),
                                               p + clen, inf))
        badm = torch.minimum(badm, torch.where(at_total & (sym != 256),
                                               p, inf))
        outp2 = outp + 1
        fexp2 = torch.where(outp2 >= rs, 2, 0)
        f |= two & (outp2 < total) & (rowpos2 == 0) & (s2 != fexp2)
        badm = torch.minimum(badm, torch.where(two & (outp2 == total),
                                               p + clen, inf))
        fail |= f
    chk = torch.stack([fail.any(dim=1).to(i64), eobm.amin(dim=1),
                       badm.amin(dim=1)], dim=1)
    return meta, metb, chk.to(posr.dtype)


def finalize_records8(posr, raw0, raw1, nst, e_fin, out0, *, k8: int,
                      h: int, bpl: int, c: int):
    """Kernel B4: walk records -> deposit records + constraint checks.

    posr/raw0/raw1 (B, ST, NC) walk records (rows >= k8 unread); nst,
    e_fin, out0 (B, NC); posr and e_fin of the walk's position dtype, the
    rest int32.  Returns (meta, metb, chk): meta (B, k8, NC) int32
    data-raster slots (row-major h x bpl, filter bytes excluded; 0 <= slot
    <= h*bpl), metb (B, k8, NC) int32 values - (0x100 | v1) | (0x100 | v2)
    << 16, v2 in the slot after v1, 0 = no literal - and chk (B, 3)
    (fail, eob_end, bad_end) of posr's dtype, with that dtype's largest
    value (INF for int32) for "none".  Literals whose output offset lies at
    or past the raster end (post-EOB garbage) deposit nothing, so every
    deposited slot is distinct.

    A CUDA tensor launches csrc/finalize8.cu (a block a tile of lanes x
    rows; the running offset a scan down each lane).
    """
    if posr.device.type == "cpu":
        return finalize_records8_plain(posr, raw0, raw1, nst, e_fin, out0,
                                       k8=k8, h=h, bpl=bpl, c=c)
    out = finalize_cuda("finalize_records8", posr, raw0, raw1, nst, e_fin,
                        out0, k8=k8, h=h, bpl=bpl, c=c)
    finalize_records8.launches += 1
    return out


finalize_records8.launches = 0


def finalize_cuda(name: str, posr, raw0, raw1, nst, e_fin, out0, *, k8: int,
                  h: int, bpl: int, c: int):
    """One call of csrc/finalize8.cu (finalize_records8's contract): it
    sets chk to (0, INF, INF) on the card, then runs the finalize; nothing
    is copied from the host."""
    pdt = posr.dtype
    K.require_cuda(name, raw0, raw1, nst, out0)
    K.require_cuda(name, posr, e_fin, dtype=pdt)
    B, ST, NC = posr.shape
    if not 0 < k8 <= ST or not fits(h, bpl):
        raise ValueError(f"{name}: bad k8, or a raster past the walk "
                         "path's limit")
    dev = posr.device
    meta = torch.empty((B, k8, NC), dtype=torch.int32, device=dev)
    metb = torch.empty_like(meta)
    chk = torch.empty((B, 3), dtype=pdt, device=dev)  # set by it
    K.check(K.lib().fpng_finalize8(
        posr.data_ptr(), raw0.data_ptr(), raw1.data_ptr(), ST,
        nst.data_ptr(), e_fin.data_ptr(), out0.data_ptr(), B, NC, k8, h, bpl,
        c, int(pdt == torch.int64), meta.data_ptr(), metb.data_ptr(),
        chk.data_ptr(), K.stream_ptr(dev)), "fpng_finalize8")
    return meta, metb, chk


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def decode_kernel8(stream, lut, p0, zlib_len, *, h: int, w: int, c: int,
                   zlib_len_max: int, maxit: int = MAXIT):
    """walk8 decode of B same-shape fpng dynamic-block streams.

    Same inputs as ops/specdec.decode_kernel.  Returns (imgs (B, h, w, c)
    uint8, ok (B,) bool, seed): seed is None when every lane fitted its
    step rows; when one overflowed, imgs and ok are None and seed is
    resume_seed of the converged entries - the PK=1 walk's fixpoint - for
    the caller to decode the batch on the PK=1 walk from; the records are
    freed on return.  One device->host readback: steps, passes (added to
    walk_fix8.passes and, in a traced call, to the counters
    decoder.walk8_passes and decoder.walk8_walks, utils/trace.py) and the
    overflow flags; it is the host wait of the walk8 card clock.
    """
    records, e_fin, out0, steps, ovf, passes = decode_walk8(
        stream, lut, p0, zlib_len, n_chunks=n_chunks(zlib_len_max),
        maxit=maxit)
    diag = torch.cat([steps.view(1).to(torch.int32), passes.view(1),
                      ovf.to(torch.int32)])
    with trace.host_wait():
        diag = diag.cpu()
    walk_fix8.passes += int(diag[1])
    trace.count("decoder.walk8_walks")
    trace.count("decoder.walk8_passes", int(diag[1]))
    if bool(diag[2:].any()):
        return None, None, resume_seed(*records, e_fin)
    k8 = trim_steps(int(diag[0]), records[0].shape[1])
    return (*finish_decode(finalize_records8, records, e_fin, out0, zlib_len,
                           k8=k8, h=h, w=w, c=c), None)


def _block(n: int) -> int:
    """The bytes torch's caching allocator counts for a buffer of n bytes:
    n rounded up to 512, and a buffer past 1 MiB may take a cached block
    up to 1 MiB longer, which the allocator does not split."""
    return -(-n // 512) * 512 + (1 << 20 if n > 1 << 20 else 0)


def decode_bytes(B: int, NC: int, ST: int, h: int, bpl: int, *,
                 finish: bool = True) -> int:
    """Device bytes a walk decode of B images holds at its peak on a card:
    decode_kernel8 with ST = 8 * MAXIT, decode_kernel_pk1 with ST8, over
    NC = n_chunks(zlib_len_max) lanes of rasters h x bpl.  Its packed
    inputs, already on the card, are not counted.  With finish=False, only
    the walk and the epilogue (a walk8 attempt that overflows).  A PK=1
    decode that resumes from walk8 holds no more: its seed is its walk's
    entry buffer (walk_cuda).  Positions take 4 or 8 bytes (pos_dtype(NC)).

    The stages, each the buffers it holds at once (walk_cuda,
    walk_offsets, finalize_cuda, scatter_packed16, expand):
      walk      the (B, ST, NC) position records and two int32 record
                arrays, three position and two int32 (B, NC) lane arrays
                (entries, both exits; nst, ovf), one bool lane array, the
                LUTs as int32
      epilogue  the records, e_fin, nst, the overflow and live flags, the
                two int32 sums and _lane_sums' temporaries (or, after
                them, the int64 prefix sum and its difference)
      finish    the records, e_fin, nst, out0, the finalize's meta and
                metb at the worst k8 = ST rows, the int16 raster, the
                uint8 image and B6's scratch
    plus B-sized tensors, each counted at the allocator's 512 bytes.

    The plan (models/decoder.dispatch_kernel) asks this before launching
    any tier, so the sizes matter where one image comes near the card.
    The largest raster the walk takes (fits: h * (bpl + 1) < 2^30, 1 074 M
    bytes), with a stream as long as its raster (the encoder stores a
    longer one), has 16.8 M lanes of 64-bit positions: its walk8 decode
    counts 96 rows x 16 B (position, two record words) + 8 B of meta and
    metb a lane, 38.7 GB, and 3.2 GB of raster, image and scratch; its PK=1
    decode, 536 rows x 24 B a lane, 216 GB, past any card, so the plan
    never launches it and an overflow of that walk8 decode takes the
    chunked decode.  The 10800 x 21600 x 3 whole-globe raster (699.85 M
    bytes) with a stream as long as its raster (10.9 M lanes) counts
    27.2 GB on walk8 and 143 GB on PK=1; its 1-pass mosaic, whose stream
    is about half its raster, about 13 GB and 70 GB."""
    ps = 8 if pos_dtype(NC) == torch.int64 else 4
    lane, flag = _block(4 * B * NC), _block(B * NC)
    plane = _block(ps * B * NC)
    rec = _block(4 * B * ST * NC)
    prec = _block(ps * B * ST * NC)  # the position records
    few = 16 * _block(24 * B)
    R = min(_EPI_ROWS, ST)
    slab = _block(ps * B * R * NC) + 3 * _block(B * R * NC) + plane
    walk = prec + 2 * rec + 3 * plane + 2 * lane + flag + \
        _block(4 * 4096 * B) + few
    epilogue = prec + 2 * rec + plane + 3 * lane + 2 * flag + few + \
        max(slab, 2 * _block(8 * B * NC) + lane)
    if not finish:
        return max(walk, epilogue)
    _, strip, bands, strips = tiling(h, bpl)
    meta = rec  # (B, k8, NC) int32 at the worst k8 = ST
    fin = prec + 2 * rec + plane + 2 * lane + 2 * meta + \
        _block(2 * B * h * bpl) + _block(B * h * bpl) + \
        _block(_scratch_bytes(B, strip, bands, strips)) + few
    return max(walk, epilogue, fin)


def finish_decode(finalize, records, e_fin, out0, zlib_len, *, k8: int,
                  h: int, w: int, c: int):
    """Stage 2 with the finalize `finalize` (finalize_records8, or the PK=1
    finalize_records): deposit records and checks over the first k8 rows,
    the ok flags, then B5 and B6.  Returns (imgs (B, h, w, c) uint8, ok
    (B,) bool)."""
    bpl = w * c
    meta, metb, chk = finalize(*records, e_fin, out0, k8=k8, h=h, bpl=bpl,
                               c=c)
    inf = torch.iinfo(chk.dtype).max
    chk = chk.to(torch.int64)
    eob_end = chk[:, 1]
    ok = (chk[:, 0] == 0) & (eob_end != inf) & (eob_end <= chk[:, 2]) & \
        (((eob_end + 7) >> 3) == zlib_len.to(torch.int64) - 4)
    raster = scatter_packed16(meta, metb, h * bpl)
    return expand(raster, h=h, w=w, c=c), ok
