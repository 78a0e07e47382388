"""walk8 decode: the default device decode (counterpart of
fpng_tpu/ops/walk8.py).

The reference decodes its single deflate block with a sequential 12-bit
table loop (fpng.cpp:2209-2901).  Here the stream is cut into S = 512-bit
chunks and one lane walks each chunk:

  B3 walk_fix8          from every chunk boundary, walk tokens with the
                        packed LUT (one step = one token, or two literals
                        when the LUT packs a second one), recording each
                        step's position, sym/outlen/clen/flags word and
                        second literal; then iterate the chunk entries to a
                        fixpoint (entry[c] = exit[c-1], entry[0] = p0),
                        re-walking only lanes whose corrected entry is not
                        among their recorded positions
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
flag; B3 stops that image at its first converged overflow, and
decode_kernel8 returns None: the caller decodes the batch on the PK=1
walk (ops/specdec_tpu.py), which runs the same kernels at worst-case
capacity, without the stop, through walk_cuda, walk_offsets,
finalize_cuda and finish_decode.  The whole walk is one launch; the host
reads nothing back until the epilogue's single readback.

Records are step-major, (B, ST, NC): lane c's step j sits at [b, j, c], so
the lanes of a warp read and write neighbouring words.  The Pallas
kernels' PK=8 sublane packing, select-chain word windows, lpi/gchunk
geometry, narrow 23-bit records and 256-slot row padding are TPU layout
and are not carried over.

Every kernel wrapper takes its plain torch version for a CPU tensor and
launches its CUDA kernel (csrc/walk8.cu, csrc/finalize8.cu) for a CUDA
tensor, or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import kernels as K
from .bitpack import MASK32, scatter_packed16
from .expand import expand

S = 512           # chunk bits
MAXIT = 12        # step slots per lane: ST = 8 * maxit (as fpng_tpu's)
_MEMB = 32        # fixpoint membership window, in steps (as fpng_tpu's)
INF = 0x7FFFFFFF


def fits(h: int, bpl: int) -> bool:
    """The walk path's raster gate: fpng_tpu's walk gate counted on the
    rows that fpng_tpu allocates (ROADMAP A12), H8 * bpl_pad < 2^27 with
    H8 = ceil(h/8)*8 and rows of 256 slots or more padded to a multiple of
    256.  The port's own raster is unpadded, and its kernels need only
    h * (bpl + 1) < 2^30 (B4's int32 output offsets).  The tighter gate
    stays until a card run holds a larger raster (A12): past it the port
    has run nothing on a walk, and the chunked decode that takes those
    rasters stops at 2^27 slots too.  The decode dispatch and the walk
    finalizes (B4, B9) all take it from here."""
    bpl_pad = bpl if bpl < 256 else -(-bpl // 256) * 256
    return -(-h // 8) * 8 * bpl_pad < 1 << 27


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


def _walk_plain(words64, lut64, ent, bound, act, posr, raw0, raw1):
    """Walk every lane with `act` set from `ent` until it reaches `bound`,
    stops on an invalid code, or fills its ST step slots.  Writes the rows
    of the steps taken; returns (exit, steps taken, still active)."""
    ST = posr.shape[1]
    nw = words64.shape[1] - 2
    pos = ent.clone()
    nst = torch.zeros_like(ent)
    for j in range(ST):
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
        extra = (w >> clen) & ((1 << nextra) - 1)
        stop = clen == 0
        l2 = (e >> 25) & 15
        two = (sym < 256) & ~stop & (l2 > 0)
        tok = clen + torch.where(is_m, nextra + 1, 0) + \
            torch.where(two, l2, 0)
        run = ((e >> 16) & 0x1FF) + extra
        outlen = torch.where(sym < 256, 1, torch.where(is_m, run, 0)) + \
            two.to(torch.int64)
        r0 = (sym | (~stop).to(torch.int64) << 9 | outlen << 10 | clen << 19 |
              is_m.to(torch.int64) << 23)
        r1 = torch.where(two, ((e >> 16) & 0xFF) | 0x100, 0)
        posr[:, j] = torch.where(act, pos, posr[:, j])
        raw0[:, j] = torch.where(act, r0, raw0[:, j])
        raw1[:, j] = torch.where(act, r1, raw1[:, j])
        nst += act.to(torch.int64)
        adv = act & ~stop
        pos = torch.where(adv, pos + tok, pos)
        act = adv & (pos < bound)
    return pos, nst, act


def _advance_front(front, done, ent, ex, ovf, live):
    """The converged front after a pass: lanes below front[b] are final
    (their entry never changes again).  The lane at the old front is final
    now, since its predecessor was final a pass earlier; each later lane c
    is final while entry[c] == exit[c-1].  An image whose newly final lanes
    include a live overflowing one is done: its overflow is decided."""
    NC = ent.shape[1]
    c = torch.arange(NC, device=ent.device)[None]
    ok = torch.ones_like(live)
    ok[:, 1:] = ent[:, 1:] == ex[:, :-1]
    stop = torch.where((c > front[:, None]) & ~ok, c, NC).amin(dim=1)
    fresh = (c >= front[:, None]) & (c < stop[:, None])
    return stop, done | (fresh & ovf & live).any(dim=1)


def fixpoint_plain(words, lut, p0, zl8, *, n_chunks: int, ST: int,
                   abort_on_overflow: bool):
    """The walk and fixpoint of kernels B3 and B8 in torch ops, with ST step
    rows a lane.  Returns walk_fix8's seven outputs and stopped (B,) int32:
    for an image stopped at its first converged overflow (only with
    abort_on_overflow), the pass after which it stopped, counting pass 0
    as 1; 0 for an image that ran on."""
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
    ent = bit0.expand(B, NC).clone()
    ent[:, :1] = p0
    ex, nst, ovf = _walk_plain(words64, lut64, ent, bound,
                               live & (ent < bound), posr, raw0, raw1)
    front = torch.zeros(B, dtype=torch.int64, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    stopped = torch.zeros(B, dtype=torch.int32, device=dev)
    passes = 1
    if abort_on_overflow:
        front, done = _advance_front(front, done, ent, ex, ovf, live)
        stopped = torch.where(done & (stopped == 0), passes, stopped)
    M = min(_MEMB, ST)
    rows = torch.arange(M, device=dev)[None, :, None]
    for _ in range(NC + 1):
        passes += 1
        e_new = torch.cat([p0, ex[:, :-1]], dim=1)
        chg = (e_new != ent) & live & ~done[:, None]
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
        if abort_on_overflow:
            front, done = _advance_front(front, done, ent, ex, ovf, live)
            stopped = torch.where(done & (stopped == 0), passes, stopped)
    i32 = torch.int32
    return (ent.to(i32), nst.to(i32), ovf, posr.to(i32), raw0.to(i32),
            raw1.to(i32), torch.tensor(passes, dtype=i32, device=dev)), \
        stopped


def walk_fix8_plain(words, lut, p0, zl8, *, n_chunks: int,
                    maxit: int = MAXIT):
    """Plain torch version of kernel B3 (same contract as walk_fix8)."""
    return fixpoint_plain(words, lut, p0, zl8, n_chunks=n_chunks,
                          ST=8 * maxit, abort_on_overflow=True)[0]


def walk_fix8(words, lut, p0, zl8, *, n_chunks: int, maxit: int = MAXIT):
    """Kernel B3: walk + entry fixpoint over n_chunks 512-bit lanes.

    words (B, NW) int32 LE stream words (reads past NW are zero); lut
    (B, 4096) int32 packed LUTs (ops/specdec.pack_lut); p0 (B,) first
    token bit; zl8 (B,) stream end bit (8 * zlib_len).  Returns (e_fin,
    nst, ovf, posr, raw0, raw1, passes): per-lane converged entry, steps
    recorded and overflow flag (B, NC); step-major records (B, ST, NC)
    int32 - rows at or past a lane's nst are unspecified; and the number
    of walk passes as a 0-dim int32 tensor on the input's device (pass 0
    plus every fixpoint pass, the last of which finds no change).

    An image stops at its first converged overflow: once a lane that can
    no longer change (every lane before it converged) has overflowed, the
    image's overflow is decided and its lanes stop re-walking.  On such an
    image only the overflow flags are defined; every other image runs on
    to convergence, so its outputs do not depend on the abort.

    A CUDA tensor launches csrc/walk8.cu once for the whole walk; nothing
    is read back.  `walk_fix8.launches` counts the launches and
    `walk_fix8.passes` the passes that decode_kernel8 reads back.
    """
    if words.device.type == "cpu":
        return walk_fix8_plain(words, lut, p0, zl8, n_chunks=n_chunks,
                               maxit=maxit)
    out = walk_cuda("walk_fix8", words, lut, p0, zl8, n_chunks=n_chunks,
                    ST=8 * maxit, abort_on_overflow=True)
    walk_fix8.launches += 1
    return out


walk_fix8.launches = 0
walk_fix8.passes = 0


def walk_cuda(name: str, words, lut, p0, zl8, *, n_chunks: int, ST: int,
              abort_on_overflow: bool):
    """Run csrc/walk8.cu's walk and fixpoint with ST step rows a lane, in
    one cooperative launch (walk_fix8's contract; the stop at the first
    converged overflow only with abort_on_overflow).  The launch's grid,
    blocks per SM and shared-memory LUT slots are left in
    `walk_cuda.launch`."""
    K.require_cuda(name, words, lut, p0, zl8)
    B, nw = words.shape
    NC = n_chunks
    if lut.shape != (B, 4096) or p0.shape != (B,) or zl8.shape != (B,):
        raise ValueError(f"{name}: lut (B, 4096), p0 and zl8 (B,)")
    if (NC + 1) * S >= 1 << 31:
        raise ValueError(f"{name}: stream too long for int32 positions")
    dev = words.device
    posr, raw0, raw1 = (torch.empty((B, ST, NC), dtype=torch.int32,
                                    device=dev) for _ in range(3))
    ent, nst, ovf, ex0, ex1 = (torch.empty((B, NC), dtype=torch.int32,
                                           device=dev) for _ in range(5))
    # changed flags (3), passes, then per image three front slots of the
    # new front and the first overflow, and the stop flag
    ctl = torch.zeros(4 + 7 * B, dtype=torch.int32, device=dev)
    info = (ctypes.c_int * 3)()
    K.check(K.lib().fpng_walk8(
        words.data_ptr(), nw, lut.data_ptr(), p0.data_ptr(), zl8.data_ptr(),
        B, NC, ST, int(abort_on_overflow), ent.data_ptr(), ex0.data_ptr(),
        ex1.data_ptr(), nst.data_ptr(), ovf.data_ptr(), posr.data_ptr(),
        raw0.data_ptr(), raw1.data_ptr(), ctl.data_ptr(),
        ctypes.addressof(info), K.stream_ptr(dev)), "fpng_walk8")
    walk_cuda.launch = dict(zip(("grid", "blocks_per_sm", "lut_slots"), info))
    return ent, nst, ovf != 0, posr, raw0, raw1, ctl[3]


walk_cuda.launch = None


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
    ops on either device."""
    dev = stream.device
    zl8 = zlib_len.to(torch.int64) * 8
    i32 = torch.int32
    e_fin, nst, ovf_l, posr, raw0, raw1, passes = walk(
        stream_words(stream), lut.to(i32).contiguous(), p0.to(i32),
        zl8.to(i32), n_chunks=n_chunks)
    ST = posr.shape[1]
    _, live, _ = _lane_geometry(zl8, n_chunks)
    stepi = torch.arange(ST, dtype=i32, device=dev)[None, :, None]
    e3 = e_fin[:, None]
    recb = ((raw0 >> 9) & 1).bool() & live[:, None] & (stepi < nst[:, None])
    clen = (raw0 >> 19) & 15
    validr = recb & (posr >= e3)
    dem = recb & (raw1 != 0) & (posr < e3) & (posr + clen == e3)
    outl = ((raw0 >> 10) & 511).to(torch.int64)
    outb = (torch.where(validr, outl, 0) +
            torch.where(dem, outl - 1, 0)).sum(dim=1)
    outb = torch.where(live, outb, 0)
    # int64 sum, clamped: every offset past 2^30 lies past any raster the
    # walk path takes, and the clamp keeps B4's int32 carries from wrapping
    out0 = torch.clamp(torch.cumsum(outb, dim=1) - outb, max=1 << 30)
    steps = torch.where(validr | dem, stepi + 1, 0).amax()
    ovf = (ovf_l & live).any(dim=1)
    return (posr, raw0, raw1, nst), e_fin, out0.to(i32), steps, ovf, passes


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
    rs = bpl + 1
    total = h * rs
    n_slots = h * bpl
    carry = out0.to(i64)
    e_l = e_fin.to(i64)
    meta = torch.empty((B, k8, NC), dtype=torch.int32, device=dev)
    metb = torch.empty_like(meta)
    fail = torch.zeros((B, NC), dtype=torch.bool, device=dev)
    eobm = torch.full((B, NC), INF, dtype=i64, device=dev)
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
                                               p + clen, INF))
        badm = torch.minimum(badm, torch.where(at_total & (sym != 256),
                                               p, INF))
        outp2 = outp + 1
        fexp2 = torch.where(outp2 >= rs, 2, 0)
        f |= two & (outp2 < total) & (rowpos2 == 0) & (s2 != fexp2)
        badm = torch.minimum(badm, torch.where(two & (outp2 == total),
                                               p + clen, INF))
        fail |= f
    chk = torch.stack([fail.any(dim=1).to(i64), eobm.amin(dim=1),
                       badm.amin(dim=1)], dim=1)
    return meta, metb, chk.to(torch.int32)


def finalize_records8(posr, raw0, raw1, nst, e_fin, out0, *, k8: int,
                      h: int, bpl: int, c: int):
    """Kernel B4: walk records -> deposit records + constraint checks.

    posr/raw0/raw1 (B, ST, NC) int32 walk records (rows >= k8 unread);
    nst, e_fin, out0 (B, NC) int32.  Returns (meta, metb, chk): meta
    (B, k8, NC) int32 data-raster slots (row-major h x bpl, filter bytes
    excluded; 0 <= slot <= h*bpl), metb (B, k8, NC) int32 values -
    (0x100 | v1) | (0x100 | v2) << 16, v2 in the slot after v1, 0 = no
    literal - and chk (B, 3) int32 (fail, eob_end, bad_end) with INF for
    "none".  Literals whose output offset lies at or past the raster end
    (post-EOB garbage) deposit nothing, so every deposited slot is
    distinct.

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
    K.require_cuda(name, posr, raw0, raw1, nst, e_fin, out0)
    B, ST, NC = posr.shape
    if not 0 < k8 <= ST or not fits(h, bpl):
        raise ValueError(f"{name}: bad k8, or a raster past the walk "
                         "path's gate")
    dev = posr.device
    meta = torch.empty((B, k8, NC), dtype=torch.int32, device=dev)
    metb = torch.empty_like(meta)
    chk = torch.empty((B, 3), dtype=torch.int32, device=dev)  # set by it
    K.check(K.lib().fpng_finalize8(
        posr.data_ptr(), raw0.data_ptr(), raw1.data_ptr(), ST,
        nst.data_ptr(), e_fin.data_ptr(), out0.data_ptr(), B, NC, k8, h, bpl,
        c, meta.data_ptr(), metb.data_ptr(), chk.data_ptr(),
        K.stream_ptr(dev)), "fpng_finalize8")
    return meta, metb, chk


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def decode_kernel8(stream, lut, p0, zlib_len, *, h: int, w: int, c: int,
                   zlib_len_max: int, maxit: int = MAXIT):
    """walk8 decode of B same-shape fpng dynamic-block streams.

    Same inputs as ops/specdec.decode_kernel.  Returns (imgs (B, h, w, c)
    uint8, ok (B,) bool), or None when a lane overflowed its step
    capacity (the caller decodes the batch on the PK=1 walk).  One
    device->host readback: steps, passes (added to walk_fix8.passes) and
    the overflow flags.
    """
    records, e_fin, out0, steps, ovf, passes = decode_walk8(
        stream, lut, p0, zlib_len, n_chunks=n_chunks(zlib_len_max),
        maxit=maxit)
    diag = torch.cat([steps.view(1).to(torch.int32), passes.view(1),
                      ovf.to(torch.int32)]).cpu()
    walk_fix8.passes += int(diag[1])
    if bool(diag[2:].any()):
        return None
    k8 = trim_steps(int(diag[0]), records[0].shape[1])
    return finish_decode(finalize_records8, records, e_fin, out0, zlib_len,
                         k8=k8, h=h, w=w, c=c)


def finish_decode(finalize, records, e_fin, out0, zlib_len, *, k8: int,
                  h: int, w: int, c: int):
    """Stage 2 with the finalize `finalize` (finalize_records8, or the PK=1
    finalize_records): deposit records and checks over the first k8 rows,
    the ok flags, then B5 and B6.  Returns (imgs (B, h, w, c) uint8, ok
    (B,) bool)."""
    bpl = w * c
    meta, metb, chk = finalize(*records, e_fin, out0, k8=k8, h=h, bpl=bpl,
                               c=c)
    chk = chk.to(torch.int64)
    eob_end = chk[:, 1]
    ok = (chk[:, 0] == 0) & (eob_end != INF) & (eob_end <= chk[:, 2]) & \
        (((eob_end + 7) >> 3) == zlib_len.to(torch.int64) - 4)
    raster = scatter_packed16(meta, metb, h * bpl)
    return expand(raster, h=h, w=w, c=c), ok
