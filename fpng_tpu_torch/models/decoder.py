"""Batched decoder pipeline (counterpart of fpng_tpu/models/decoder.py).

The host does the O(1)-per-image work (container chunk walk, dynamic
header parse and 12-bit LUT build, fpng.cpp:1954-2105); the device does
everything O(pixels) through the chunked speculative walk
(ops/specdec.py): lockstep token walks from every chunk boundary -> entry
fixpoint -> recording walk with full constraint validation -> literal
deposit (kernel B10) + per-row RLE forward fill -> defilter cumsum.

Any constraint violation flips the image's ok flag and the API reports
FPNG_DECODE_NOT_FPNG, as the reference does.  Stored-block files decode on
the host (fpng.cpp:2107-2207), and streams whose token count overflows the
walk's step bound are handed to the host decoder; decode_batch counts the
images of each kind in `decode_batch.device_images` and
`decode_batch.host_handoffs`.
"""

from __future__ import annotations

import numpy as np
import torch

from fpng_tpu import constants as C

from ..ops.specdec import decode_kernel, pack_lut, plan_chunks
from ..tables import lut_to_torch


def _parse_one(png: bytes):
    """Container + header parse for one file.

    Returns (status, w, h, ch, stream_bytes, p0_bits, zlib_len, lut) -
    lut None => host path needed (stored blocks) or reject.  Uses the
    native runtime (fpng_tpu/runtime/native.cpp) when available, else the
    Python twins (fpng_tpu.container / fpng_tpu.golden).
    """
    import os

    from fpng_tpu import runtime
    from fpng_tpu.container import get_info_internal

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

    from fpng_tpu.bitio import BitReader
    from fpng_tpu.golden import _parse_dynamic_header

    r = BitReader(src)
    r.skip(16)
    if r.get(1) != 1 or r.get(2) != 2:
        return C.FPNG_DECODE_NOT_FPNG, w, h, ch, None, 0, 0, None
    lut = _parse_dynamic_header(r, ch)
    if lut is None:
        return C.FPNG_DECODE_NOT_FPNG, w, h, ch, None, 0, 0, None
    return (C.FPNG_DECODE_SUCCESS, w, h, ch, src, r.bit_pos, idat_len,
            lut)


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


def dispatch_kernel(sj, lj, pj, zj, *, h: int, w: int, c: int, nb: int):
    """The decode over already-packed device inputs.

    Returns (imgs, ok, overflow, path); the only path so far is the
    chunked decode ("chunked").  The walk8 chain replaces it as the
    default in a later port step (ROADMAP A7).
    """
    s_bits, n_chunks, max_steps = plan_chunks(nb)
    imgs, ok, overflow = decode_kernel(
        sj, lj, pj, zj, h=h, w=w, c=c, n_chunks=n_chunks,
        chunk_bits=s_bits, max_steps=max_steps)
    return imgs, ok, overflow, "chunked"


def _decode_launch(pngs: list[bytes], desired_channels: int, device):
    """Host container/header parse + device decode launch.  Returns opaque
    state for _decode_finish_host."""
    from fpng_tpu.golden import convert_channels, decode_stored

    n = len(pngs)
    statuses = [C.FPNG_DECODE_INVALID_ARG] * n
    images: list = [None] * n
    if desired_channels not in (3, 4):
        return (statuses, images, [], desired_channels, [])

    metas = [_parse_one(p) for p in pngs]
    groups: dict = {}
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
            # more bytes than any stream of this length can code (a token
            # takes >= 1 bit and writes <= 258 bytes): the reference
            # rejects it too, so it needs no device pass
            statuses[i] = C.FPNG_DECODE_NOT_FPNG
            continue
        groups.setdefault((h, w, ch), []).append(i)

    launched = []
    for (h, w, ch), idxs in groups.items():
        B = len(idxs)
        max_len = max(len(metas[i][4]) for i in idxs)
        nb = 64
        while nb < max_len:
            nb *= 2
        stream = np.zeros((B, nb), np.uint8)
        luts = np.zeros((B, 4096), np.uint32)
        p0 = np.zeros(B, np.int64)
        zl = np.zeros(B, np.int64)
        for j, i in enumerate(idxs):
            _, _, _, _, src, p, zlib_len, lut = metas[i]
            stream[j, :len(src)] = np.frombuffer(src, np.uint8)
            luts[j] = pack_lut(lut)
            p0[j] = p
            zl[j] = zlib_len
        imgs, ok, overflow, _path = dispatch_kernel(
            torch.from_numpy(stream).to(device), lut_to_torch(luts, device),
            torch.from_numpy(p0).to(device), torch.from_numpy(zl).to(device),
            h=h, w=w, c=ch, nb=nb)
        launched.append(((h, w, ch), idxs, metas, imgs, ok, overflow))
    return (statuses, images, launched, desired_channels, metas)


def _decode_finish_host(state):
    """Device readback + per-image status resolution."""
    from fpng_tpu.golden import convert_channels, decode_zlib

    statuses, images, launched, desired_channels, _metas = state
    for (h, w, ch), idxs, metas, imgs, ok, overflow in launched:
        imgs = imgs.cpu().numpy()
        ok = ok.cpu().numpy()
        overflow = overflow.cpu().numpy()
        for j, i in enumerate(idxs):
            if ok[j]:
                statuses[i] = C.FPNG_DECODE_SUCCESS
                images[i] = convert_channels(imgs[j], desired_channels)
                decode_batch.device_images += 1
            elif overflow[j]:
                # the stream's token count exceeded the walk's step bound
                # (sub-2.7-bit/token codes): the host decoder takes it
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
