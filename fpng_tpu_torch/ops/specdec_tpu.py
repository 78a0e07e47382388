"""PK=1 decode: the worst-case walk (counterpart of the walk path of
fpng_tpu/ops/specdec_tpu.py).

fpng_tpu decodes a batch on its PK=1 walk when a walk8 lane overflows its
96 step rows.  The two walks compute the same thing and differ only in
capacity: PK=1 gives every 512-bit chunk lane ST8 = 512 + 24 step rows,
enough for a token of one bit at every step.  What else separates them on
the TPU (PK=8 sublane packing, lpi groups run in grid order, plan_tpu's
lane buckets, 23-bit narrow records, bpl_pad row padding, the k8 cache) is
TPU layout.  So here:

  B8 walk_fix          kernel B3's walk and fixpoint (csrc/walk8.cu) at
                       ST = ST8, over n_chunks(zlib_len_max) lanes; after
                       a walk8 overflow it resumes from walk8's converged
                       entries (ops/walk8.resume_seed), which are its own
                       fixpoint, and reads 2 passes
  epilogue             ops/walk8.walk_offsets
  B9 finalize_records  kernel B4's finalize (csrc/finalize8.cu) over the
                       trimmed k8 <= ST8 rows
  B5, B6               as walk8 (ops/walk8.finish_decode)

Bit positions are int32 or, for a stream of 2^31 bits or more, int64
(ops/walk8.pos_dtype), in both walks.  At 536 rows a lane a PK=1 decode
holds about 5.6 times walk8's records, so where one image's PK=1 decode
does not fit the card the plan never launches it
(models/decoder.plan_tiers).  Each wrapper keeps its own launch counter,
apart from walk8's, so a run shows which walk it took.  A CPU tensor takes
the plain versions (walk8's at ST8 rows); a CUDA tensor launches the
kernels or raises.
"""

from __future__ import annotations

import functools

import torch

from ..utils import trace
from . import walk8 as W

ST8 = W.CAP  # step rows a lane: every step a walk takes


def walk_fix_plain(words, lut, p0, zl8, *, n_chunks: int, seed=None):
    """Plain torch version of kernel B8: B3's walk and fixpoint at ST8
    rows."""
    return W.fixpoint_plain(words, lut, p0, zl8, n_chunks=n_chunks, ST=ST8,
                            seed=seed)


def walk_fix(words, lut, p0, zl8, *, n_chunks: int, seed=None):
    """Kernel B8: the PK=1 walk + entry fixpoint, with walk_fix8's
    contract at ST8 step rows a lane.  A lane of a valid stream never
    fills its rows, so the overflow flag it returns is not read.  seed
    (B, NC) int32, when given, is ops/walk8.resume_seed of walk_fix8's
    converged entries, which are this walk's fixpoint: from them it reads
    2 passes to the same entries, offsets and deposits.  The seed is the
    walk's entry buffer (ops/walk8.walk_cuda): it is returned as e_fin.

    A CUDA tensor runs the whole walk in csrc/walk8.cu's launch and the
    jump's after it (ops/walk8.walk_cuda); `walk_fix.launches` counts the
    walks and `walk_fix.passes` the passes that decode_kernel_pk1 reads
    back.
    """
    if words.device.type == "cpu":
        return walk_fix_plain(words, lut, p0, zl8, n_chunks=n_chunks,
                              seed=seed)
    out = W.walk_cuda("walk_fix", words, lut, p0, zl8, n_chunks=n_chunks,
                      ST=ST8, seed=seed)
    walk_fix.launches += 1
    return out


walk_fix.launches = 0
walk_fix.passes = 0


# the plain torch version of kernel B9 is B4's, which takes any k8
finalize_records_plain = W.finalize_records8_plain


def finalize_records(posr, raw0, raw1, nst, e_fin, out0, *, k8: int, h: int,
                     bpl: int, c: int):
    """Kernel B9: PK=1 walk records -> deposit records + constraint checks,
    with finalize_records8's contract and records, for k8 <= ST8.
    fpng_tpu's _finalize_records writes narrow records into bpl_pad rows;
    the raster they deposit and the per-image check triple are the same.

    A CUDA tensor launches csrc/finalize8.cu; `finalize_records.launches`
    counts the launches.
    """
    if posr.device.type == "cpu":
        return finalize_records_plain(posr, raw0, raw1, nst, e_fin, out0,
                                      k8=k8, h=h, bpl=bpl, c=c)
    out = W.finalize_cuda("finalize_records", posr, raw0, raw1, nst, e_fin,
                          out0, k8=k8, h=h, bpl=bpl, c=c)
    finalize_records.launches += 1
    return out


finalize_records.launches = 0


def decode_kernel_pk1(stream, lut, p0, zlib_len, *, h: int, w: int, c: int,
                      zlib_len_max: int, seed=None):
    """PK=1 decode of B same-shape fpng dynamic-block streams.

    Same inputs as ops/walk8.decode_kernel8, and seed: what
    decode_kernel8 returns on an overflow (its converged entries, by
    ops/walk8.resume_seed), for B8 to resume from (walk_fix), or None.
    Returns (imgs (B, h, w, c) uint8, ok (B,) bool); it has no capacity
    overflow.  One device->host readback: the step trim and the passes
    (added to walk_fix.passes and, in a traced call, to the counters
    decoder.pk1_passes and decoder.pk1_walks, and decoder.pk1_resumed for
    a seeded walk; it is the host wait of the PK=1 card clock,
    utils/trace.py).
    """
    walk = walk_fix if seed is None else \
        functools.partial(walk_fix, seed=seed)
    records, e_fin, out0, steps, _, passes = W.walk_offsets(
        walk, stream, lut, p0, zlib_len, n_chunks=W.n_chunks(zlib_len_max))
    diag = torch.stack([steps.to(torch.int32), passes])
    with trace.host_wait():
        diag = diag.cpu()
    walk_fix.passes += int(diag[1])
    trace.count("decoder.pk1_walks")
    trace.count("decoder.pk1_passes", int(diag[1]))
    if seed is not None:
        trace.count("decoder.pk1_resumed")
    k8 = W.trim_steps(int(diag[0]), ST8)
    return W.finish_decode(finalize_records, records, e_fin, out0, zlib_len,
                           k8=k8, h=h, w=w, c=c)
