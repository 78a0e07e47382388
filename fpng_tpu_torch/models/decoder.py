"""Batched decoder pipeline (counterpart of fpng_tpu/models/decoder.py).

The host does the O(1)-per-image work (container chunk walk, dynamic
header parse and 12-bit LUT build, fpng.cpp:1954-2105); the device does
everything O(pixels).  dispatch_kernel is fpng_tpu's chain without its
`except` degrade, with the tiers chosen before launch by the card's memory:

  within the port's raster limit (ops/walk8.fits: h * (bpl + 1) < 2^30):
    walk8 (ops/walk8.py, kernels B3-B6)          the default
    -> PK=1 (ops/specdec_tpu.py, B8, B9, B5, B6) when a walk8 lane
                                                 overflows its step
                                                 capacity, resumed from
                                                 walk8's converged entries;
                                                 or straight away (from the
                                                 chunk boundaries) with
                                                 FPNG_TPU_WALK8=0
  past the limit, or where the image's walk cannot fit the card:
    chunked decode (ops/specdec.py, B10)
    -> host decoder (golden.decode_zlib)         per image, when the chunked
                                                 walk's step bound overflows

The memory plan (dispatch_kernel, plan_tiers) stands in for fpng_tpu's
`except`: from the models of each tier's bytes (ops/walk8.decode_bytes,
ops/specdec.chunked_bytes) and the card's free memory it splits a walked
group into sub-batches whose PK=1 decode fits; where not even one image's
PK=1 decode fits, into sub-batches whose walk8 decode fits, a walk8
overflow then taking the chunked decode where that fits and raising
MemoryError where it does not; where no walk fits, the group takes the
chunked decode, and where that does not fit either the call raises
MemoryError before any launch.  fpng_tpu's own walk gate (2^27 allocated
slots, its TPU's VMEM) is not the port's: a whole-globe raster of
699.85 M bytes decodes on walk8.

Any constraint violation flips the image's ok flag and the API reports
FPNG_DECODE_NOT_FPNG, as the reference does.  Stored-block files decode on
the host (fpng.cpp:2107-2207).  decode_batch counts images decoded on the
device (`device_images`), images handed to the host decoder
(`host_handoffs`, only from the chunked tier), device decodes launched
(`sub_batches`: one a group, or one a sub-batch of a split group),
sub-batches whose walk8 overflowed (`walk8_overflows`) and groups by the
furthest path that decoded them (`paths`); these count on every call.  A
kernel that fails to build or launch raises.

Spans (utils/trace.py): a call is traced while a torch.profiler session
is enabled or while `decode_batch.spans` is a dict; untraced, a span reads
one flag.  A traced call opens a profiler range and a registry entry for
each stage - `decoder.parse`, `.host_stored`, `.pack`, `.h2d`, `.device`,
`.d2h`, `.finish` - and inside `.device` for the memory plan
(`decoder.plan`: _free_bytes, plan_tiers, and its decision in the
counters below) and each tier of the walk (`decoder.walk8`, B3's attempt
and, where it fits, B4-B6, whose card time the registry keeps as
`decoder.walk8_card_s`; `decoder.pk1`, the re-walk through B8, B9, the
epilogue, B5 and B6, as `decoder.pk1_card_s`).  The plan counts the images
it plans (`decoder.images`), those of each walked tier
(`decoder.tier.walk8_pk1`, `.walk8_chunked`, `.walk8`) and those that
take the chunked decode (`decoder.chunked_images`), by reason:
`decoder.chunked_past_limit` (past ops/walk8.fits) or
`decoder.chunked_no_room` (the image's walk cannot fit the card: no walk
planned, or a walk8 overflow where PK=1 cannot fit).  The seven stages'
host seconds also go into `decode_batch.spans` when it is a dict.  No span
synchronises the card: a stage that queues card work is charged the
host's time to queue it.  decode_batch_stream pipelines batches: batch
k+1 is launched before batch k's readback is waited for.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from .. import constants as C
from ..ops.specdec import chunked_bytes, decode_kernel, pack_lut, plan_chunks
from ..ops.specdec_tpu import ST8, decode_kernel_pk1
from ..ops.walk8 import MAXIT, decode_bytes, decode_kernel8, fits, n_chunks
from ..utils import trace
from .transfer import finish_readback, start_readback, to_device


def _parse_one(png: bytes):
    """Container + header parse for one file.

    Returns (status, w, h, ch, stream_bytes, p0_bits, zlib_len, lut) -
    lut None => host path needed (stored blocks) or reject.  Uses the
    native runtime (runtime/native.cpp) when available, else the Python
    twins (container.py / golden.py).
    """
    from .. import runtime
    from ..container import get_info_internal

    # runtime twin of the reference's FPNG_DISABLE_DECODE_CRC32_CHECKS
    # compile-time switch (fpng.cpp:50-53), used by fuzzing drivers
    check_crcs = not os.environ.get("FPNG_TPU_DISABLE_DECODE_CRC32_CHECKS")
    native = runtime.available()
    if native:
        status, w, h, ch, idat_ofs, idat_len = runtime.get_info_internal(
            png, check_crcs)
    else:
        status, w, h, ch, idat_ofs, idat_len = get_info_internal(
            png, check_crcs)
    if status != C.FPNG_DECODE_SUCCESS:
        return status, w, h, ch, None, 0, 0, None
    src = png[idat_ofs + 8:]
    if idat_len < 7 or len(src) < 3 or src[0] != C.ZLIB_HDR0 or \
            src[1] != C.ZLIB_HDR1:
        return C.FPNG_DECODE_NOT_FPNG, w, h, ch, None, 0, 0, None
    if (src[2] & 6) == 0:  # stored blocks: host path
        return C.FPNG_DECODE_SUCCESS, w, h, ch, src, -1, idat_len, None

    if native:
        res = runtime.parse_dyn_header(src, ch)
        if res is None:
            return C.FPNG_DECODE_NOT_FPNG, w, h, ch, None, 0, 0, None
        lut, p0 = res
        return C.FPNG_DECODE_SUCCESS, w, h, ch, src, p0, idat_len, lut

    from ..bitio import BitReader
    from ..golden import _parse_dynamic_header

    r = BitReader(src)
    r.skip(16)
    if r.get(1) != 1 or r.get(2) != 2:
        return C.FPNG_DECODE_NOT_FPNG, w, h, ch, None, 0, 0, None
    lut = _parse_dynamic_header(r, ch)
    if lut is None:
        return C.FPNG_DECODE_NOT_FPNG, w, h, ch, None, 0, 0, None
    return (C.FPNG_DECODE_SUCCESS, w, h, ch, src, r.bit_pos, idat_len,
            lut)


def pack_streams(metas):
    """_parse_one results of dynamic-block files -> the device decode's
    inputs: (stream (B, nb) uint8 zero padded to a power of two >= 64
    bytes, packed LUTs (B, 4096) uint32, p0 (B,) int64, zlib_len (B,)
    int64)."""
    B = len(metas)
    nb = 64
    while nb < max(len(m[4]) for m in metas):
        nb *= 2
    stream = np.zeros((B, nb), np.uint8)
    luts = np.zeros((B, 4096), np.uint32)
    p0 = np.zeros(B, np.int64)
    zl = np.zeros(B, np.int64)
    for j, (_, _, _, _, src, p, zlib_len, lut) in enumerate(metas):
        stream[j, :len(src)] = np.frombuffer(src, np.uint8)
        luts[j] = pack_lut(lut)
        p0[j] = p
        zl[j] = zlib_len
    return stream, luts, p0, zl


def decode_batch(pngs: list[bytes], desired_channels: int = 4,
                 with_info: bool = False, device="cuda"):
    """Decode a batch of fpng PNGs on `device`.

    Returns (statuses, images): FPNG_DECODE_* codes and (h, w, desired)
    uint8 arrays (None on failure).  With with_info=True also returns
    infos, a list of (w, h, channels_in_file) from the container parse.
    All dynamic-block files sharing an (h, w, ch) shape go through one
    device decode.
    """
    state = _decode_launch(pngs, desired_channels, device, "decode_batch")
    statuses, images = _decode_finish_host(state)
    if with_info:
        metas = state[4]
        infos = ([(m[1], m[2], m[3]) for m in metas] if metas
                 else [(0, 0, 0)] * len(pngs))
        return statuses, images, infos
    return statuses, images


decode_batch.device_images = 0
decode_batch.host_handoffs = 0
decode_batch.walk8_overflows = 0
decode_batch.sub_batches = 0
decode_batch.paths = {"walk8": 0, "pk1": 0, "chunked": 0}
decode_batch.spans = None


@contextlib.contextmanager
def _span(name: str, device):
    """The decoder's stage `name` as the span `decoder.<name>`
    (utils/trace.py); while decode_batch.spans is a dict, the stage's host
    seconds are also added to spans[name].  Nothing synchronises: `device`
    is no longer read, and stays for callers that wrap this function."""
    spans = decode_batch.spans
    with trace.span("decoder." + name) as s:
        yield
    if spans is not None and s is not None:
        spans[name] = spans.get(name, 0.0) + s.seconds


def _use_walk8() -> bool:
    """walk8 is the default decode; FPNG_TPU_WALK8=0 selects the PK=1 walk,
    the same switch as fpng_tpu's."""
    return os.environ.get("FPNG_TPU_WALK8", "1") != "0"


# bytes of the card kept out of the walk decode's budget: room for the
# caching allocator's fragmentation and for memory outside it
_MARGIN = 2 << 30


def _free_bytes(device):
    """The decode's budget on `device`: the card's free memory plus
    what torch's caching allocator holds unused, less _MARGIN; None off
    the card (no split).  Read at launch, so whatever is already on the
    card (a batch in flight, a mesh shard's neighbours) is counted."""
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    return free + torch.cuda.memory_reserved(device) - \
        torch.cuda.memory_allocated(device) - _MARGIN


def plan_sub_batches(B: int, nbytes, budget, out_bytes: int):
    """Contiguous [start, stop) sub-batches of B images: one when budget
    is None or nbytes(B) fits it; otherwise as many images a sub-batch as
    nbytes(b) allows beside the whole (B x out_bytes) output that the
    sub-batches fill, and never fewer than one."""
    if budget is None or nbytes(B) <= budget:
        return [(0, B)]
    room = budget - B * out_bytes
    b = 1
    while b < B and nbytes(b + 1) <= room:
        b += 1
    return [(i, min(i + b, B)) for i in range(0, B, b)]


def plan_tiers(B: int, nb: int, h: int, w: int, c: int, zmax: int,
               budget):
    """The tiers of a group of B images of h x w x c, their streams packed
    nb bytes wide and zmax bytes long at most, and its sub-batches, before
    anything launches: (tier, parts).  Within the walk path's raster limit
    (ops/walk8.fits) the first of these whose model fits the budget, whole
    or one image a sub-batch beside the output (plan_sub_batches):
      "walk8_pk1"      the walk chain, by its PK=1 decode (decode_bytes at
                       ST8 rows, the larger tier);
      "walk8_chunked"  walk8 enabled, by its walk8 decode and the chunked
                       decode (chunked_bytes) that takes a sub-batch whose
                       walk8 overflows;
      "walk8"          walk8 enabled, by its walk8 decode alone: a walk8
                       overflow raises MemoryError.
    Otherwise ("chunked_no_room", [(0, B)]), and past the limit
    ("chunked_past_limit", [(0, B)]), where the chunked decode of the
    group fits; MemoryError where nothing does.  budget None (the CPU)
    plans a single walk8_pk1 batch, or the chunked decode past the
    limit."""
    bpl = w * c

    def chunked(b):
        return chunked_bytes(b, nb, h, w, c)

    walks = fits(h, bpl)
    if walks:
        nc = n_chunks(zmax)

        def walk(ST):
            return lambda b: decode_bytes(b, nc, ST, h, bpl)

        w8, on = walk(8 * MAXIT), _use_walk8()
        for tier, nbytes, allowed in (
                ("walk8_pk1", walk(ST8), True),
                ("walk8_chunked", lambda b: max(w8(b), chunked(b)), on),
                ("walk8", w8, on)):
            if allowed and (budget is None or nbytes(B) <= budget or
                            nbytes(1) <= budget - B * h * bpl):
                return tier, plan_sub_batches(B, nbytes, budget, h * bpl)
    if budget is None or chunked(B) <= budget:
        return "chunked_no_room" if walks else "chunked_past_limit", [(0, B)]
    raise MemoryError(
        f"decode of {B} images of {h} x {w} x {c}: no tier fits the card's "
        f"{budget} free bytes (the chunked decode needs {chunked(B)})")


def _chunked(sj, lj, pj, zj, *, h: int, w: int, c: int):
    """The chunked decode (B10) of a group or sub-batch: (imgs, ok,
    overflow, "chunked")."""
    s_bits, lanes, max_steps = plan_chunks(sj.shape[1])
    return (*decode_kernel(sj, lj, pj, zj, h=h, w=w, c=c, n_chunks=lanes,
                           chunk_bits=s_bits, max_steps=max_steps),
            "chunked")


def _walk_chain(sj, lj, pj, zj, *, h: int, w: int, c: int, zmax: int,
                tier: str = "walk8_pk1"):
    """One sub-batch through walk8, then on an overflow PK=1 resumed from
    walk8's converged entries (tier walk8_pk1; or PK=1 straight away with
    FPNG_TPU_WALK8=0), the chunked decode (tier walk8_chunked, where PK=1
    cannot fit the card) or MemoryError (tier walk8, where neither fits):
    (imgs, ok, overflow, path).  Each tier is a span; the walk8 and PK=1
    tiers' card time is clocked (trace.card_clock)."""
    decode_batch.sub_batches += 1
    seed = None
    if _use_walk8():
        with trace.span("decoder.walk8"), \
                trace.card_clock("decoder.walk8_card_s", sj.device):
            imgs, ok, seed = decode_kernel8(sj, lj, pj, zj, h=h, w=w, c=c,
                                            zlib_len_max=zmax)
        if seed is None:
            return imgs, ok, torch.zeros_like(ok), "walk8"
        decode_batch.walk8_overflows += 1
        if tier != "walk8_pk1":
            del seed  # frees the entries before the chunked decode allocates
            if tier == "walk8":
                raise MemoryError("a walk8 lane overflowed its step rows, "
                                  "and neither PK=1 nor the chunked decode "
                                  "fits the card")
            n = sj.shape[0]
            trace.count("decoder.chunked_images", n)
            trace.count("decoder.chunked_no_room", n)
            return _chunked(sj, lj, pj, zj, h=h, w=w, c=c)
    with trace.span("decoder.pk1"), \
            trace.card_clock("decoder.pk1_card_s", sj.device):
        imgs, ok = decode_kernel_pk1(sj, lj, pj, zj, h=h, w=w, c=c,
                                     zlib_len_max=zmax, seed=seed)
    return imgs, ok, torch.zeros_like(ok), "pk1"


_PATHS = ("walk8", "pk1", "chunked")


def dispatch_kernel(sj, lj, pj, zj, *, h: int, w: int, c: int, zmax: int,
                    mem_budget=None):
    """The decode dispatch over already-packed device inputs
    (pack_streams), zmax the longest zlib_len: the walk chain within the
    port's raster limit (ops/walk8.fits), the chunked decode past it.

    The memory plan stands in for fpng_tpu's `except` around its walks:
    before anything launches, plan_tiers chooses the tiers from the models
    (ops/walk8.decode_bytes, ops/specdec.chunked_bytes) and the budget -
    mem_budget bytes, or by default the card's free memory at launch
    (_free_bytes; none on the CPU) - and splits the group into contiguous
    sub-batches:
      walk8 -> PK=1      where one image's PK=1 decode fits: sub-batches
                         whose PK=1 decode (the larger tier, since a walk8
                         overflow decodes the same sub-batch again on PK=1)
                         fits beside the output;
      walk8 -> chunked   where only walk8 and the chunked decode fit: a
                         walk8 overflow takes the chunked decode for its
                         sub-batch;
      walk8              where only walk8 fits: an overflow raises
                         MemoryError;
      chunked            past the limit, or where no walk fits (or PK=1
                         does not and FPNG_TPU_WALK8=0 asks for it
                         straight away) and the chunked decode does.
    Where nothing fits it raises MemoryError before any launch.  So no
    decode is launched where its model says it cannot fit.  Each sub-batch
    runs its chain; outputs are joined in image order.  Nothing catches a
    failed launch.  The chunked decode is not split, as fpng_tpu has no
    degrade around it.  The plan's decision is counted inside the
    `decoder.plan` span (module docstring).

    Returns (imgs, ok, overflow, path) where path names the furthest
    decode that ran ("walk8", "pk1" or "chunked") and overflow flags the
    images the chunked walk could not finish (the caller decodes them on
    the host).
    """
    B = sj.shape[0]
    with trace.span("decoder.plan"):
        trace.count("decoder.images", B)
        budget = _free_bytes(sj.device) if mem_budget is None else mem_budget
        tier, parts = plan_tiers(B, sj.shape[1], h, w, c, zmax, budget)
        if tier.startswith("chunked"):
            trace.count("decoder.chunked_images", B)
            trace.count("decoder." + tier, B)
        else:
            trace.count("decoder.tier." + tier, B)
    if tier.startswith("chunked"):
        decode_batch.sub_batches += 1
        return _chunked(sj, lj, pj, zj, h=h, w=w, c=c)
    kw = dict(h=h, w=w, c=c, zmax=zmax, tier=tier)
    if len(parts) == 1:
        return _walk_chain(sj, lj, pj, zj, **kw)
    imgs = torch.empty((B, h, w, c), dtype=torch.uint8, device=sj.device)
    ok = torch.empty(B, dtype=torch.bool, device=sj.device)
    overflow = torch.zeros_like(ok)
    path = "walk8"
    for a, b in parts:
        imgs[a:b], ok[a:b], overflow[a:b], sub = _walk_chain(
            sj[a:b], lj[a:b], pj[a:b], zj[a:b], **kw)
        path = max(path, sub, key=_PATHS.index)
    return imgs, ok, overflow, path


def _decode_launch(pngs: list[bytes], desired_channels: int, device,
                   op: str):
    """Host container/header parse, device decode launch and the start of
    its readback (transfer.start_readback).  Returns opaque state for
    _decode_finish_host.  Each walk is one launch that the host does not
    wait on; the launch waits only for the walk's single readback (steps,
    passes, overflow), which the step trim needs.  The call is traced as
    `op` (utils/trace.py) and its number ends the state."""
    call = trace.begin(op, force=decode_batch.spans is not None)
    with trace.within(call):
        from ..golden import convert_channels, decode_stored

        n = len(pngs)
        statuses = [C.FPNG_DECODE_INVALID_ARG] * n
        images: list = [None] * n
        if desired_channels not in (3, 4):
            return (statuses, images, [], desired_channels, [], call)

        with _span("parse", device):
            metas = [_parse_one(p) for p in pngs]
        groups: dict = {}
        with _span("host_stored", device):
            for i, m in enumerate(metas):
                status, w, h, ch, src, p0, zlib_len, lut = m
                if status != C.FPNG_DECODE_SUCCESS:
                    statuses[i] = status
                    continue
                if w * h * desired_channels > 0xFFFFFFFF:
                    # output allocation guard (fpng.cpp:3103-3111)
                    statuses[i] = C.FPNG_DECODE_FAILED_DIMENSIONS_TOO_LARGE
                    continue
                if lut is None:
                    img = decode_stored(src, zlib_len, w, h, ch)
                    if img is None:
                        statuses[i] = C.FPNG_DECODE_NOT_FPNG
                    else:
                        statuses[i] = C.FPNG_DECODE_SUCCESS
                        images[i] = convert_channels(img, desired_channels)
                    continue
                if h * (1 + w * ch) > 258 * 8 * zlib_len:
                    # more bytes than any stream of this length can code (a
                    # token takes >= 1 bit and writes <= 258 bytes): the
                    # reference rejects it too, so it needs no device pass
                    statuses[i] = C.FPNG_DECODE_NOT_FPNG
                    continue
                groups.setdefault((h, w, ch), []).append(i)

        launched = []
        for (h, w, ch), idxs in groups.items():
            with _span("pack", device):
                stream, luts, p0, zl = pack_streams(
                    [metas[i] for i in idxs])
            with _span("h2d", device):
                args = tuple(to_device(a, device) for a in (
                    stream, luts.astype(np.int64), p0, zl))
            with _span("device", device):
                imgs, ok, overflow, path = dispatch_kernel(
                    *args, h=h, w=w, c=ch, zmax=int(zl.max()))
            decode_batch.paths[path] += 1
            with _span("d2h", device):
                readback = start_readback((imgs, ok, overflow))
            launched.append(((h, w, ch), idxs, metas, readback))
        return (statuses, images, launched, desired_channels, metas,
                call)


def _decode_finish_host(state):
    """Wait for the readback, then resolve each image's status; the call's
    card clock is read once the readbacks are in (trace.settle)."""
    from ..golden import convert_channels, decode_zlib

    statuses, images, launched, desired_channels, _metas, call = state
    with trace.within(call):
        for (h, w, ch), idxs, metas, readback in launched:
            imgs, ok, overflow = finish_readback(readback)
            with _span("finish", "cpu"):
                for j, i in enumerate(idxs):
                    if ok[j]:
                        statuses[i] = C.FPNG_DECODE_SUCCESS
                        images[i] = convert_channels(imgs[j],
                                                     desired_channels)
                        decode_batch.device_images += 1
                    elif overflow[j]:
                        # the stream's token count exceeded the chunked
                        # walk's step bound (sub-2.7-bit/token codes): the
                        # host decoder takes it
                        decode_batch.host_handoffs += 1
                        _, _, _, _, src, _, zlib_len, _ = metas[i]
                        img = decode_zlib(src, zlib_len, w, h, ch)
                        if img is None:
                            statuses[i] = C.FPNG_DECODE_NOT_FPNG
                        else:
                            statuses[i] = C.FPNG_DECODE_SUCCESS
                            images[i] = convert_channels(img,
                                                         desired_channels)
                    else:
                        statuses[i] = C.FPNG_DECODE_NOT_FPNG
        trace.settle()
    return statuses, images


def decode_batch_stream(png_batches, desired_channels: int = 4,
                        device="cuda"):
    """Pipelined multi-batch decode on `device`: yields (statuses, images)
    per input list of PNGs, in order, each as decode_batch gives it.
    Batch k+1's host parse and device decode are launched before batch k's
    readback is waited for and its statuses resolved."""
    pending = None
    for pngs in png_batches:
        state = _decode_launch(list(pngs), desired_channels, device,
                               "decode_batch_stream")
        if pending is not None:
            yield _decode_finish_host(pending)
        pending = state
    if pending is not None:
        yield _decode_finish_host(pending)
