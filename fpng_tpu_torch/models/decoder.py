"""Batched decoder pipeline (counterpart of fpng_tpu/models/decoder.py).

The host does the O(1)-per-image work (container chunk walk, dynamic
header parse and 12-bit LUT build, fpng.cpp:1954-2105); the device does
everything O(pixels).  dispatch_kernel is fpng_tpu's chain without its
`except` degrade:

  within the walk gate (ops/walk8.fits):
    walk8 (ops/walk8.py, kernels B3-B6)          the default
    -> PK=1 (ops/specdec_tpu.py, B8, B9, B5, B6) when a walk8 lane
                                                 overflows its step
                                                 capacity, or straight away
                                                 with FPNG_TPU_WALK8=0
  past the gate:
    chunked decode (ops/specdec.py, B10)
    -> host decoder (golden.decode_zlib)         per image, when the chunked
                                                 walk's step bound overflows

Any constraint violation flips the image's ok flag and the API reports
FPNG_DECODE_NOT_FPNG, as the reference does.  Stored-block files decode on
the host (fpng.cpp:2107-2207).  decode_batch counts images decoded on the
device (`device_images`), images handed to the host decoder
(`host_handoffs`, only from the chunked tier), device batches whose walk8
overflowed (`walk8_overflows`) and device batches by the path that decoded
them (`paths`).  Setting `decode_batch.spans` to a dict turns on per-stage
host-clock spans (off by default; see _span).  A kernel that fails to
build or launch raises.  decode_batch_stream pipelines batches: batch k+1
is launched before batch k's readback is waited for.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from .. import constants as C
from ..ops.specdec import decode_kernel, pack_lut, plan_chunks
from ..ops.specdec_tpu import decode_kernel_pk1
from ..ops.walk8 import decode_kernel8, fits
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
    state = _decode_launch(pngs, desired_channels, device)
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
decode_batch.paths = {"walk8": 0, "pk1": 0, "chunked": 0}
decode_batch.spans = None


@contextlib.contextmanager
def _span(name: str, device):
    """Add the host-clock time of the block to decode_batch.spans[name]
    when spans is a dict; do nothing when it is None.  On a CUDA device the
    span synchronises at both ends, so the device work a stage queues is
    charged to that stage."""
    spans = decode_batch.spans
    if spans is None:
        yield
        return
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    t = time.perf_counter()
    yield
    if cuda:
        torch.cuda.synchronize(device)
    spans[name] = spans.get(name, 0.0) + time.perf_counter() - t


def _use_walk8() -> bool:
    """walk8 is the default decode; FPNG_TPU_WALK8=0 selects the PK=1 walk,
    the same switch as fpng_tpu's."""
    return os.environ.get("FPNG_TPU_WALK8", "1") != "0"


def dispatch_kernel(sj, lj, pj, zj, *, h: int, w: int, c: int, zmax: int):
    """The decode dispatch - walk8 -> PK=1 within the walk gate, the
    chunked decode past it - over already-packed device inputs
    (pack_streams), zmax the longest zlib_len.

    Returns (imgs, ok, overflow, path) where path names the decode that
    ran ("walk8", "pk1" or "chunked") and overflow flags the images the
    chunked walk could not finish (the caller decodes them on the host).
    """
    if fits(h, w * c):
        if _use_walk8():
            out = decode_kernel8(sj, lj, pj, zj, h=h, w=w, c=c,
                                 zlib_len_max=zmax)
            if out is not None:
                imgs, ok = out
                return imgs, ok, torch.zeros_like(ok), "walk8"
            decode_batch.walk8_overflows += 1
        imgs, ok = decode_kernel_pk1(sj, lj, pj, zj, h=h, w=w, c=c,
                                     zlib_len_max=zmax)
        return imgs, ok, torch.zeros_like(ok), "pk1"
    s_bits, n_chunks, max_steps = plan_chunks(sj.shape[1])
    imgs, ok, overflow = decode_kernel(
        sj, lj, pj, zj, h=h, w=w, c=c, n_chunks=n_chunks,
        chunk_bits=s_bits, max_steps=max_steps)
    return imgs, ok, overflow, "chunked"


def _decode_launch(pngs: list[bytes], desired_channels: int, device):
    """Host container/header parse, device decode launch and the start of
    its readback (transfer.start_readback).  Returns opaque state for
    _decode_finish_host.  The walks read a pass flag back each fixpoint
    pass, so the device decode itself has run by the time this returns."""
    from ..golden import convert_channels, decode_stored

    n = len(pngs)
    statuses = [C.FPNG_DECODE_INVALID_ARG] * n
    images: list = [None] * n
    if desired_channels not in (3, 4):
        return (statuses, images, [], desired_channels, [])

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
            stream, luts, p0, zl = pack_streams([metas[i] for i in idxs])
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
    return (statuses, images, launched, desired_channels, metas)


def _decode_finish_host(state):
    """Wait for the readback, then resolve each image's status."""
    from ..golden import convert_channels, decode_zlib

    statuses, images, launched, desired_channels, _metas = state
    for (h, w, ch), idxs, metas, readback in launched:
        imgs, ok, overflow = finish_readback(readback)
        with _span("finish", "cpu"):
            for j, i in enumerate(idxs):
                if ok[j]:
                    statuses[i] = C.FPNG_DECODE_SUCCESS
                    images[i] = convert_channels(imgs[j], desired_channels)
                    decode_batch.device_images += 1
                elif overflow[j]:
                    # the stream's token count exceeded the chunked walk's
                    # step bound (sub-2.7-bit/token codes): the host
                    # decoder takes it
                    decode_batch.host_handoffs += 1
                    _, _, _, _, src, _, zlib_len, _ = metas[i]
                    img = decode_zlib(src, zlib_len, w, h, ch)
                    if img is None:
                        statuses[i] = C.FPNG_DECODE_NOT_FPNG
                    else:
                        statuses[i] = C.FPNG_DECODE_SUCCESS
                        images[i] = convert_channels(img, desired_channels)
                else:
                    statuses[i] = C.FPNG_DECODE_NOT_FPNG
    return statuses, images


def decode_batch_stream(png_batches, desired_channels: int = 4,
                        device="cuda"):
    """Pipelined multi-batch decode on `device`: yields (statuses, images)
    per input list of PNGs, in order, each as decode_batch gives it.
    Batch k+1's host parse and device decode are launched before batch k's
    readback is waited for and its statuses resolved."""
    pending = None
    for pngs in png_batches:
        state = _decode_launch(list(pngs), desired_channels, device)
        if pending is not None:
            yield _decode_finish_host(pending)
        pending = state
    if pending is not None:
        yield _decode_finish_host(pending)
