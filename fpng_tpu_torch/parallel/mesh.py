"""Data-parallel runs over several devices (counterpart of
fpng_tpu/parallel/mesh.py).

A PNG batch is data-parallel image by image, so a batch splits into
contiguous shards, one per device of a Mesh, and each shard runs the
single-device pipeline on its own device: every shard's device work is
queued before any shard's results are read back.  The only collective is
the table-training step: per-shard token histograms are summed on the
mesh's first device and then, when torch.distributed is initialised,
all-reduced over the default process group (gloo for CPU tensors, NCCL
for CUDA tensors) - fpng_tpu's histogram psum.

A mesh may list a device more than once: eight "cpu" entries stand in for
fpng_tpu's virtual 8-device CPU mesh in the tests, and ["cuda:0",
"cuda:0"] exercises the split and the join on one card.  make_mesh() with
no devices takes every card and raises where there is none; the CPU is
used only when the caller lists it.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from .. import constants as C
from ..models import encoder as enc
from ..models.decoder import (_parse_one, decode_batch, dispatch_kernel,
                              pack_streams)
from ..models.transfer import finish_readback, start_readback, to_device
from ..tables import one_pass_state
from ..utils import trace


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A one-axis device mesh: the batch axis `axis` split over `devices`
    in order."""
    devices: tuple
    axis: str = "dp"

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(devices=None, axis: str = "dp") -> Mesh:
    """A mesh over `devices` (device names or torch.device, repeats
    allowed), by default every CUDA card; raises when there is none."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("make_mesh: no CUDA device (list the devices, "
                               "e.g. ['cpu'] * 8, to run on the CPU)")
        devices = [f"cuda:{i}" for i in range(n)]
    devs = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        devs.append(d)
    if not devs:
        raise ValueError("make_mesh: no devices")
    return Mesh(tuple(devs), axis)


def _on(device: torch.device):
    """Make `device` the current CUDA device for the block (the kernels
    launch on the current device's stream); nothing for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _shard_len(mesh: Mesh, B: int) -> int:
    if B % mesh.size:
        raise ValueError(f"batch {B} not divisible by mesh size {mesh.size}")
    return B // mesh.size


def _split(mesh: Mesh, arr):
    k = _shard_len(mesh, len(arr))
    return [arr[i * k:(i + 1) * k] for i in range(mesh.size)]


def shard_batch(mesh: Mesh, arr) -> list:
    """A (B, ...) host array as contiguous (B / n, ...) tensors, one on
    each device of the mesh, in order."""
    return [to_device(a, d)
            for a, d in zip(_split(mesh, np.asarray(arr)), mesh.devices)]


def encode_batch_sharded(mesh: Mesh, images, flags: int = 0) -> list[bytes]:
    """encode_batch with the batch split over the mesh; B must be
    divisible by the mesh size.  Byte-identical to encode_batch: each
    shard runs its launch (2-pass: its histogram first, for every shard)
    on its device, and only then are the shards' results read back, in
    order."""
    images = np.ascontiguousarray(images, dtype=np.uint8)
    host = _split(mesh, images)
    enc._validate(images)
    if flags & C.FPNG_FORCE_UNCOMPRESSED:
        return [enc._stored_png(img) for img in images]
    dev = shard_batch(mesh, images)
    hists = []
    for d, x in zip(mesh.devices, dev):
        with _on(d):
            hists.append(enc._hist(x, flags))
    launched = []
    for d, x, h, hx in zip(mesh.devices, dev, hists, host):
        with _on(d):
            launched.append(enc._encode_launch(x, hx, flags, h))
    out: list[bytes] = []
    for hx, state in zip(host, launched):
        out += enc._encode_finish(hx, state)
    return out


def _reduce_hist(mesh: Mesh, partials) -> torch.Tensor:
    """Sum per-shard (288,) histograms on the mesh's first device, then
    all-reduce the sum over the default process group when there is one:
    the training collective."""
    total = sum(p.to(mesh.devices[0]) for p in partials)
    if torch.distributed.is_available() and \
            torch.distributed.is_initialized():
        torch.distributed.all_reduce(total, op=torch.distributed.ReduceOp.SUM)
    return total


def training_step(mesh: Mesh, imgs, num_chans: int) -> torch.Tensor:
    """One table-training step: the (288,) int64 token histogram of the
    whole corpus, replicated on every process.  `imgs` is a (B, H, W, C)
    host batch, or shard_batch's shards of one."""
    shards = imgs if isinstance(imgs, list) else shard_batch(mesh, imgs)
    partials = []
    for d, x in zip(mesh.devices, shards):
        with _on(d):
            partials.append(enc.hist_kernel(x, num_chans=num_chans).sum(0))
    return _reduce_hist(mesh, partials)


def decode_batch_sharded(mesh: Mesh, pngs: list, h: int, w: int, ch: int):
    """Device decode of same-shape dynamic-block fpng files with the batch
    split over the mesh: each shard goes through the decode dispatch
    (models/decoder.dispatch_kernel: walk8, then PK=1 on an overflow, the
    tiers planned by the shard's card memory; the chunked decode past the
    walk path's raster limit or where no walk fits) on its device, and
    images whose chunked walk could not finish go to the host decoder, as
    in decode_batch.  The paths and hand-offs count in decode_batch's
    counters.  Returns (imgs (B, h, w, ch) uint8, ok (B,) bool) as numpy
    arrays.

    A traced call (utils/trace.py, op `decode_batch_sharded`) spans each
    shard's launch (`mesh.shard`) and readback wait (`mesh.readback`), the
    shard's index in the range's args, and the join of the shards' results
    with the host hand-offs (`mesh.join`)."""
    from ..golden import decode_zlib

    _shard_len(mesh, len(pngs))
    metas = [_parse_one(p) for p in pngs]
    for status, mw, mh, mc, src, p0, zlen, lut in metas:
        if status != 0 or lut is None or (mw, mh, mc) != (w, h, ch):
            raise ValueError("decode_batch_sharded needs uniform dynamic-"
                             "block fpng files")
    stream, luts, p0, zl = pack_streams(metas)
    parts = zip(*(_split(mesh, a) for a in (stream, luts.astype(np.int64),
                                            p0, zl)))
    with trace.within(trace.begin("decode_batch_sharded")):
        launched = []
        for i, (d, part) in enumerate(zip(mesh.devices, parts)):
            with _on(d), trace.span("mesh.shard", f" shard={i}"):
                args = tuple(to_device(a, d) for a in part)
                imgs, ok, overflow, path = dispatch_kernel(
                    *args, h=h, w=w, c=ch, zmax=int(part[3].max()))
                decode_batch.paths[path] += 1
                launched.append(start_readback((imgs, ok, overflow)))
        res = []
        for i, r in enumerate(launched):
            with trace.span("mesh.readback", f" shard={i}"):
                res.append(finish_readback(r))
        trace.settle()
        with trace.span("mesh.join"):
            imgs = np.concatenate([r[0] for r in res])
            ok = np.concatenate([r[1] for r in res])
            for j in np.flatnonzero(np.concatenate([r[2] for r in res])):
                decode_batch.host_handoffs += 1
                src, zlib_len = metas[j][4], metas[j][6]
                img = decode_zlib(src, zlib_len, w, h, ch)
                ok[j] = img is not None
                if img is not None:
                    imgs[j] = img
    return imgs, ok


def full_step_sharded(mesh: Mesh, images, num_chans: int):
    """The multichip dry run's step: per shard, the 1-pass encode kernel
    with its fused token histogram (encode_kernel's want_hist), then the
    histograms' mesh-wide reduction (training_step's collective).

    Returns (words (B, num_words) int32, total_bits (B,) int64, adler (B,)
    int64, ghist (288,) int64), all on the mesh's first device; ghist
    equals training_step(mesh, images, num_chans).
    """
    B, H, W, Cc = images.shape
    num_words = max(enc._budget(H, W, Cc) // 4 + 4, 8)
    outs = []
    for d, x in zip(mesh.devices,
                    shard_batch(mesh, np.ascontiguousarray(images, np.uint8))):
        k = x.shape[0]
        with _on(d):
            st = one_pass_state(num_chans, d)

            def col(v):
                return torch.full((k,), v, dtype=torch.int32, device=d)

            outs.append(enc.encode_kernel(
                x, st.codes.expand(k, -1), st.sizes.expand(k, -1),
                col(len(st.prefix) * 8), col(st.acc), col(st.nacc),
                num_chans=num_chans, cost_check=False, want_hist=True,
                num_words=num_words))
    d0 = mesh.devices[0]
    words, total_bits, _, adler = (torch.cat([o[i].to(d0) for o in outs])
                                   for i in range(4))
    ghist = _reduce_hist(mesh, [o[4].sum(0) for o in outs])
    return words, total_bits, adler, ghist
