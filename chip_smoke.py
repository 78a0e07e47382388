#!/usr/bin/env python3
"""Smoke test of fpng_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA card.  It
builds the port's CUDA kernels from fpng_tpu_torch/csrc, then:

  3. holds each kernel bit-exact against its plain torch version at the
     main path's shapes (B1, B2 and B10 on the encoder's and the chunked
     decode's shapes; B3-B6 on the decode of the headline corpus's own
     streams; B7 on the 32 bpp 1-pass corpus's cost-check inputs; B8 and
     B9 on the decode of the 24 bpp 2-pass corpus, which overflows
     walk8), with CUDA-event times and a bytes/operations bound (B1, B4,
     B5, B7 and B9 also with the profiler's kernel time; B5 on the
     finalize's (B, k8, NC) records and flattened to (B, N)); B2 is
     the whole IDAT CRC, with the device activities of one
     launch_assemble counted by torch.profiler; then B3 once more on the
     32 bpp 1-pass corpus, whose overflowing lanes walk on to exact exits,
     so B3 reaches B8's entries and passes and B8 resumes from them in 2
     passes (each walk is one launch); B6 is held
     against its plain version on every decode's raster below as well;
  4. drives encode_batch / decode_batch (and the single-image entry
     points) at the headline size, 128 x 256 x 256 x 3: the decode takes
     the walk8 path, every file is checked with zlib and the port's
     golden, three decodes with the decoder's stage spans on give the
     stage split, one profiled decode gives the device's idle share, and
     one profiled encode (encode_profile) where the encode's device time
     goes;
  5. does the same at 2 x 2160 x 3840 x 3 (B1 held against its plain
     version on the 4K streams);
  modes: drives 24 bpp 2-pass, 32 bpp 1-pass and 32 bpp 2-pass at
     128 x 256 x 256 x c the same way (rates best of three, zlib on every
     file, golden on the distinct ones, the first 8 against the CPU run);
  6. decodes one stream that overflows walk8 through walk8 -> PK=1, 32
     images with FPNG_TPU_WALK8=0 (PK=1 straight away), and, with the
     walk gate refusing as it does for a raster past 2^27 allocated
     slots, the same 32 images on the chunked decode (B10) and the
     overflow stream through chunked -> host;
  walk_gate_edge: decodes the tallest 4K-wide raster fpng_tpu's walk gate
     admits, 1 x 5824 x 7680 x 3 (134.2 M slots; the port's own limit,
     h * (bpl + 1) < 2^30, lies at 46601 rows of that width), on walk8, on
     PK=1 (FPNG_TPU_WALK8=0) and on the chunked decode (the limit patched
     to refuse), each bit-exact against the input, zlib and the chunked
     output, with B3, B4, B5, B6 and B8 timed on its streams, each path's
     peak device memory, and the walk8 and PK=1 decodes' peaks stage by
     stage (walk, epilogue, finalize, B5, B6);
  extreme_shapes: tests/test_fuzz_shapes.py's eight shapes (dim 1, extreme
     aspect ratios) at 3 and 4 channels in 1-pass and 2-pass, and
     forced-stored at 1 x 8193 x 3: the card's PNG bytes equal the port's
     CPU run, each decodes bit-exact on the path the CPU tests pin (the
     tall shapes on PK=1);
  large_raster_2g: encodes one 1 x 6144 x 7680 x 3 raster (141.6 M bytes,
     past fpng_tpu's 2^27 gate, within the port's limit) and decodes it on
     the walk chain and on the chunked decode (the limit patched to refuse;
     B1 held against its plain version on its stream), with the encode's
     and each decode's peak device memory;
  memory_plan: decodes groups too large for one walk decode on the card,
     bit-exact: twelve edge rasters on PK=1 (FPNG_TPU_WALK8=0) in two or
     more sub-batches, and 2160 x 3840 x 4 1-pass frames (over 200 MB of
     zlib) through walk8 -> PK=1, each walk decode's modelled bytes
     (ops/walk8.decode_bytes) between 1 and 1.5 times its measured peak;
  globe: one 1 x 10800 x 21600 x 3 whole-globe mosaic (699.85 M bytes;
     the globe_rgb.decode cell's first content call, pngbench/content/
     mosaic.py), encoded on the card, checked by zlib and pngbench's plain
     reference, then decoded on walk8, on PK=1 (FPNG_TPU_WALK8=0, where
     ops/walk8.decode_bytes says it fits) and on the chunked decode (the
     limit patched), each bit-exact and timed with its peak, and the walk8
     and PK=1 decodes stage by stage against decode_bytes;
  7. decodes corrupted streams against golden's statuses;
  probes: holds the probe kernels P1 (tools/prof_depparts, all seven
     modes) and P2 (tools/prof_int8mxu, int8 and bf16), each in every one
     of its T output slots, bit-exact against their plain versions at the
     probes' own sizes, with the profiler's kernel time, P2's achieved
     TOP/s and share of the tensor-core peak, each beside PyTorch calls
     doing the same products (P1's dotbf16: one batched bf16 torch.matmul;
     dot: one torch._int_mm an image), then runs each probe's main;
  stream: encode_batch_stream over 4 headline batches and 4 32 bpp 2-pass
     batches, byte-identical to encode_batch, and decode_batch_stream over
     the same files (one corrupted in the middle batch) against
     decode_batch, each timed twice against the same batches one call at
     a time (in the order A B B A);
  bench: runs fpng_tpu_torch.bench at full size and checks its JSON line;
  cli: fpng_tpu_torch.cli's random-dims fuzz and its -f on a corrupted
     file;
  mesh: parallel/mesh.py over make_mesh() (every card) and over [cuda:0,
     cuda:0] at the headline: the sharded encode byte-identical to
     encode_batch, the sharded decode of the dynamic-block files equal to
     the input, B1, B2 and B3 once a shard, training_step against
     hist_kernel, full_step_sharded against encode_kernel, and the 32 bpp
     1-pass batch (B7 in each shard, PK=1 where a shard overflows walk8),
     with MPix/s beside the single-batch calls';
  multihost: tools/dryrun_multihost with one rank over NCCL, in its own
     process;
  harness: tools/verify_drive at 4 tiles, tools/bench_mesh on one card and
     tools/prof_walk8 at the headline, tools/bench_large at 2 x 2160 x
     3840 x 3, each one's output in its line.

    python3 chip_smoke.py --expand

times B6 alone (CUDA events, launches a call, held against expand_plain)
on the walk8 decode rasters of the headline and 4K corpora, and prints no
ok line.  It calls only functions whose contracts checkouts since B5 took
(B, S, NC) records share, so a copy of this file at the root of such a
checkout times that checkout's B6 on the same rasters.

    python3 chip_smoke.py --enc

times B1 alone at the headline, 4K and large_raster_2g shapes and B7 on
the 32 bpp 1-pass cost-check inputs (CUDA events, the profiler's kernel
time, the host's enqueue time, bounds, plain versions), each held against
its plain version, and prints no ok line.  It calls only
encode_bits_fused, encode_bits_plain, demote_mask, demote_mask_plain,
build_desc and tokens, so a copy of this file at the root of any checkout
since B7 was ported times that checkout's B1 and B7.

    python3 chip_smoke.py --globe

runs the globe phase alone (about a minute on one card) and prints no
ok line.

    python3 chip_smoke.py --p1

times P1 alone in all seven modes (CUDA events, the profiler's kernel
time, the host's enqueue time, bounds, the library calls), step T-1 held
against depparts_plain, and prints no ok line.  It calls only depparts,
depparts_plain and inputs, so a copy of this file at the root of any
checkout since P1 was ported times that checkout's P1.

The launch counters are set to 0 just before each path and read just
after, to show that the path went through its kernels.  One line of
numbers per phase; then the card, the per-kernel JSON line, and last
{"ok": true, "device": {...}}.  Any failed check raises and exits non-zero
without the ok line.  It imports no JAX and nothing of fpng_tpu.
"""

import contextlib
import functools
import io
import json
import os
import re
import subprocess
import sys
import time
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DEV = "cuda"
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and the float32 rate
# outside the tensor cores, taken as the peak of the kernels' 32-bit
# integer and logic operations (their own rate is not published higher)
HBM_BYTES_S = 3.35e12
OPS_S = 67e12
# dense tensor-core peaks (the same data sheet): int8 and bf16 operations/s
TC_INT8_OPS_S = 1979e12
TC_BF16_OPS_S = 989e12
KERNELS = [  # name, source, the TPU kernel it replaces
    ("encode_bits_fused", "fpng_tpu_torch/csrc/encfuse.cu",
     "fpng_tpu/ops/encfuse.py:188"),
    ("crc32_words_masked_raw", "fpng_tpu_torch/csrc/crc_words.cu",
     "fpng_tpu/ops/checksum.py:376"),
    ("deposit_bits", "fpng_tpu_torch/csrc/deposit.cu",
     "fpng_tpu/ops/bitpack.py:397"),
    ("walk_fix8", "fpng_tpu_torch/csrc/walk8.cu",
     "fpng_tpu/ops/walk8.py:270"),
    ("finalize_records8", "fpng_tpu_torch/csrc/finalize8.cu",
     "fpng_tpu/ops/walk8.py:537"),
    ("scatter_packed16", "fpng_tpu_torch/csrc/deposit.cu",
     "fpng_tpu/ops/bitpack.py:466"),
    ("expand", "fpng_tpu_torch/csrc/expand.cu",
     "fpng_tpu/ops/specdec_tpu.py:866"),
    ("demote_mask", "fpng_tpu_torch/csrc/demote.cu",
     "fpng_tpu/ops/encfuse.py:336"),
    ("walk_fix", "fpng_tpu_torch/csrc/walk8.cu",
     "fpng_tpu/ops/specdec_tpu.py:350"),
    ("finalize_records", "fpng_tpu_torch/csrc/finalize8.cu",
     "fpng_tpu/ops/specdec_tpu.py:721"),
    ("depparts", "fpng_tpu_torch/csrc/prof_depparts.cu",
     "tools/prof_depparts.py:70"),
    ("int8_mxu", "fpng_tpu_torch/csrc/prof_int8mxu.cu",
     "tools/prof_int8mxu.py:43"),
]
MODES = [  # name, channels, 2-pass (bench.py's real3/real4 x 1/2-pass)
    ("real3_2pass", 3, True), ("real4_1pass", 4, False),
    ("real4_2pass", 4, True)]
SHAPES = [  # tests/test_fuzz_shapes.py's: dim 1 and extreme aspect ratios
    (1, 1), (1, 8193), (8193, 1), (2, 4097), (4096, 2), (3, 2731),
    (1, 257), (513, 1)]
TALL = {(8193, 1), (4096, 2), (513, 1)}


def check(cond, what):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


T_START = time.perf_counter()


def line(phase, **nums):
    print(json.dumps({"phase": phase, **nums,
                      "elapsed_s": time.perf_counter() - T_START}),
          flush=True)


def cuda_ms(torch, fn, reps):
    """Mean device time of fn() over reps runs, after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def profiled_ms(torch, fn, reps=20):
    """(ms, {kernel: [launches recorded, ms a launch]}): the device time of
    one call of fn() by torch.profiler over reps calls after a warm-up:
    the sum over kernels of each one's mean recorded duration, times the
    launches it makes a call (the trace may miss some launches; the
    CUDA-event time of cuda_ms also holds launch gaps and host work)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.events():
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
            m = re.search(r"\w+_kernel", e.name)
            k = m.group(0) if m else e.name[:48]
            n, t = per.get(k, (0, 0.0))
            per[k] = (n + 1, t + (e.time_range.end - e.time_range.start)
                      / 1e3)
    per = {k: [n, t / n] for k, (n, t) in per.items()}
    # a name launched m times a call is recorded about m times as often as
    # the call's rarest one (a memset and a fill kernel share one name)
    n_min = min((n for n, _ in per.values()), default=1)
    return sum(round(n / n_min) * t for n, t in per.values()), per


def bound(nbytes, ops, ops_s=OPS_S):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over their peak rate (by default the 32-bit one)."""
    tb, to = nbytes / HBM_BYTES_S * 1e3, ops / ops_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def zlib_check(png, img):
    """Independent check: the IDAT CRC, zlib inflate (which checks the
    adler32) and a per-row Up defilter."""
    H, W, Cc = img.shape
    idat_len = int.from_bytes(png[50:54], "big")
    crc = int.from_bytes(png[58 + idat_len:62 + idat_len], "big")
    check(zlib.crc32(png[54:58 + idat_len]) == crc, "IDAT CRC")
    raw = zlib.decompress(png[58:58 + idat_len])
    rows = np.frombuffer(raw, np.uint8).reshape(H, 1 + W * Cc)
    if rows[0, 0] == 0 and (rows[1:, 0] == 2).all():
        rec = rows[:, 1:].copy()
        for i in range(1, H):  # row by row: a running sum down each column
            np.add(rec[i], rec[i - 1], out=rec[i])  # wraps mod 256
    else:  # stored fallback: every row filter 0
        check((rows[:, 0] == 0).all(), "filter bytes")
        rec = rows[:, 1:]
    return np.array_equal(rec.reshape(H, W, Cc), img)


def is_stored(png):
    return (png[58 + 2] & 6) == 0


def host_ms(torch, fn, calls=10):
    """The host's time to enqueue one call of fn(), nothing waited for."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    out = (time.perf_counter() - t) * 1e3 / calls
    torch.cuda.synchronize()
    return out


def b1_inputs(torch, imgs):
    """B1's arguments on the encode of a (B, H, W, c) batch with the 1-pass
    tables: (desc, tbl, base_bits, num_words)."""
    from fpng_tpu_torch.models.encoder import _budget, _num_words, build_desc
    from fpng_tpu_torch.tables import one_pass_state

    B, H, W_, Cc = imgs.shape
    st = one_pass_state(Cc, DEV)
    desc, tbl, *_ = build_desc(
        torch.from_numpy(imgs).to(DEV), st.codes.expand(B, -1),
        st.sizes.expand(B, -1),
        torch.full((B,), st.acc, dtype=torch.int32, device=DEV),
        torch.full((B,), st.nacc, dtype=torch.int32, device=DEV),
        num_chans=Cc, cost_check=False)
    base = torch.full((B,), len(st.prefix) * 8, dtype=torch.int32,
                      device=DEV)
    return desc, tbl, base, _num_words(_budget(H, W_, Cc))


def b1_checked(torch, args, what, units=None):
    """B1 against encode_bits_plain on args: every word, total_bits and
    last_tok.  With `units`, the plain version runs on slices of that many
    units, each from the bit where the slice before it ended, and ORs their
    words (their bits are disjoint), so that the int64 temporaries of a
    raster the globe's size fit the card.  The plain version's temporaries
    go back to the card (empty_cache), so that the phases after it
    allocate as they would without the check."""
    from fpng_tpu_torch.ops.encfuse import (encode_bits_fused,
                                            encode_bits_plain)

    got = encode_bits_fused(*args)
    if units is None:
        want = encode_bits_plain(*args)
    else:
        desc, tbl, start, nw = args
        words = torch.zeros_like(got[0])
        last = torch.full_like(got[2], -1)
        for a in range(0, desc.shape[1], units):
            w_, start, lt = encode_bits_plain(desc[:, a:a + units], tbl,
                                              start, nw)
            words |= w_
            last = torch.maximum(last, lt)
            del w_
        want = words, start, last
    for g, w_, name in zip(got, want, ("words", "total_bits", "last_tok")):
        check(torch.equal(g, w_), f"B1 {name} differ from plain ({what})")
    del want
    torch.cuda.empty_cache()
    return got


def b1_times(torch, args, reps=20, plain_reps=5):
    """B1's CUDA-event, profiler and enqueue times on args, its plain
    version's time, and its bound: the desc read, the table read and the
    words written once; ~20 ops a unit (lookup, scan, shifts, deposit)."""
    from fpng_tpu_torch.ops.encfuse import (encode_bits_fused,
                                            encode_bits_plain)

    desc, tbl, _, nw = args
    B, N = desc.shape
    bms, by = bound(4 * B * N + 4 * tbl.numel() + 4 * B * nw, 20 * B * N)
    return dict(
        ms=cuda_ms(torch, lambda: encode_bits_fused(*args), reps),
        **profiler_line(profiled_ms(torch, lambda: encode_bits_fused(*args),
                                    reps)),
        host_ms=host_ms(torch, lambda: encode_bits_fused(*args)),
        plain_ms=cuda_ms(torch, lambda: encode_bits_plain(*args),
                         plain_reps),
        bound_ms=bms, bound_by=by, shape=[B, N], num_words=nw)


def b7_inputs(torch, imgs):
    """B7's arguments on the cost check of a 32 bpp 1-pass batch (the
    1-pass tables)."""
    from fpng_tpu_torch.models.encoder import tokens
    from fpng_tpu_torch.tables import one_pass_state

    B = imgs.shape[0]
    st = one_pass_state(imgs.shape[3], DEV)
    deltas, _, mstart, mlen, _, ls, le = tokens(
        torch.from_numpy(imgs).to(DEV), imgs.shape[3])
    return (deltas, ls, le, mstart & (mlen == 1),
            st.tbl.expand(B, 8, 128).contiguous())


def b7_times(torch, args):
    """B7 against demote_mask_plain on args, with its CUDA-event, profiler
    and enqueue times and its bound: cand read and the mask written, a
    byte a pixel; the 4 delta bytes, len_sym and len_extra read per
    candidate; the 288 sizes per image; ~12 ops a candidate, 2 a pixel."""
    from fpng_tpu_torch.ops.encfuse import demote_mask, demote_mask_plain

    got, want = demote_mask(*args), demote_mask_plain(*args)
    check(torch.equal(got, want), "B7 mask differs from plain")
    B, H, W_, Cc = args[0].shape
    n_px, n_cand = B * H * W_, int(args[3].sum())
    check(n_cand > 0 and bool(got.any()), "the corpus has no demotion")
    bms, by = bound(2 * n_px + 12 * n_cand + 4 * 288 * B,
                    12 * n_cand + 2 * n_px)
    return dict(
        max_abs_err=int((got.to(torch.int32) - want.to(torch.int32))
                        .abs().max()),
        ms=cuda_ms(torch, lambda: demote_mask(*args), 20),
        **profiler_line(profiled_ms(torch, lambda: demote_mask(*args))),
        host_ms=host_ms(torch, lambda: demote_mask(*args)),
        plain_ms=cuda_ms(torch, lambda: demote_mask_plain(*args), 5),
        bound_ms=bms, bound_by=by, shape=[B, H, W_, Cc], candidates=n_cand,
        demoted=int(got.sum()))


def enc_times(torch, bench):
    """B1 at the headline, 4K and large_raster_2g shapes and B7 on the 32
    bpp 1-pass cost-check inputs, each held against its plain version,
    with CUDA-event, profiler and enqueue times, bounds and plain times.
    It calls only encode_bits_fused, encode_bits_plain, demote_mask,
    demote_mask_plain, build_desc and tokens, whose contracts every
    checkout since B7 was ported shares."""
    out = {}
    for name, imgs, reps, plain_reps in (
            ("headline", bench.make_corpus("real3"), 20, 5),
            ("4k", bench.make_corpus_4k(), 20, 3),
            ("2g", make_large_raster(), 10, 1)):
        args = b1_inputs(torch, imgs)
        b1_checked(torch, args, name)
        out[f"b1_{name}"] = b1_times(torch, args, reps, plain_reps)
        del args
        torch.cuda.empty_cache()
    out["b7"] = b7_times(torch, b7_inputs(torch, bench.make_corpus("real4")))
    return out


def phase_kernels(torch, imgs):
    """Each kernel against its plain version at the main path's shapes."""
    from torch.profiler import ProfilerActivity, profile

    import fpng_tpu_torch as T
    from fpng_tpu_torch.models.encoder import encode_kernel, launch_assemble
    from fpng_tpu_torch.ops import walk8 as W
    from fpng_tpu_torch.ops.assemble import (idat_crc_words,
                                             idat_crc_words_plain,
                                             raw_idat_prefix)
    from fpng_tpu_torch.ops.bitpack import (deposit_bits, from_word32,
                                            scatter_bits, scatter_packed16,
                                            scatter_packed16_plain)
    from fpng_tpu_torch.ops.checksum import _shift_tables, _word_bit_table
    from fpng_tpu_torch.ops.encfuse import (encode_bits_fused,
                                            encode_bits_plain)
    from fpng_tpu_torch.ops.expand import expand, expand_plain
    from fpng_tpu_torch.ops.expand import tiling as expand_tiling
    from fpng_tpu_torch.ops.specdec import plan_chunks
    from fpng_tpu_torch.tables import one_pass_state

    dev = torch.device(DEV)
    B, H, W_, Cc = imgs.shape
    st = one_pass_state(Cc, dev)
    b1_args = b1_inputs(torch, imgs)
    _, _, base, nw = b1_args
    res = {}

    def err(a, b):
        return int((from_word32(a) - from_word32(b)).abs().max())

    def masked_err(a, b):
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())

    # B1 against the XLA-path chain, on every word, one launch a call
    n0 = encode_bits_fused.launches
    got = b1_checked(torch, b1_args, "headline")
    check(encode_bits_fused.launches == n0 + 1, "B1 is not one launch")
    want = encode_bits_plain(*b1_args)
    res["encode_bits_fused"] = dict(max_abs_err=err(got[0], want[0]),
                                    **b1_times(torch, b1_args))
    del want

    # B2, the whole IDAT CRC, on the corpus words, masked to each image's
    # payload, against idat_crc_words_plain (torch ops on the card: the
    # parent's function) and, on 8 images, the plain version on the CPU
    words, total, _ = got
    adler = encode_kernel(torch.from_numpy(imgs).to(dev),
                          st.codes.expand(B, -1), st.sizes.expand(B, -1),
                          base, torch.full((B,), st.acc, dtype=torch.int32,
                                           device=dev),
                          torch.full((B,), st.nacc, dtype=torch.int32,
                                     device=dev), num_chans=Cc,
                          cost_check=False, want_hist=False,
                          num_words=nw)[3]
    prefixes = [st.prefix] * B
    plens = np.full(B, len(st.prefix), np.int64)
    raw_ip = raw_idat_prefix(prefixes).astype(np.int64)
    crc_args = (words, total, adler, plens, raw_ip)
    n0 = idat_crc_words.launches
    g2 = idat_crc_words(*crc_args)
    check(idat_crc_words.launches == n0 + 1, "B2 is not one launch a call")
    w2 = idat_crc_words_plain(*crc_args)
    check(torch.equal(g2, w2), "B2 CRCs differ from plain")
    cpu8 = idat_crc_words_plain(words[:8].cpu(), total[:8].cpu(),
                                adler[:8].cpu(), plens[:8], raw_ip[:8])
    check(torch.equal(g2[:8].cpu(), cpu8), "B2 CRCs differ from the CPU's")
    hi = (total.to(torch.int64) + 7) >> 3
    K = nw // 1024
    # the chunks whose bytes overlap [plen, tb): the only ones B2 reads
    tb_np = hi.cpu().numpy()
    live = np.maximum(np.minimum(-(-tb_np // 4096), K) - plens // 4096, 0)
    live_chunks = int(live.sum())
    launch_assemble(*crc_args[:3], prefixes)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        launch_assemble(*crc_args[:3], prefixes)
        torch.cuda.synchronize()
    # each device activity of one launch_assemble with its device time (the
    # CUDA-event time below also holds the host's enqueue of the upload)
    activities = [[e.name[:40], (e.time_range.end - e.time_range.start) / 1e3]
                  for e in prof.events()
                  if getattr(e, "device_type", None) ==
                  torch.autograd.DeviceType.CUDA]
    check(0 < len(activities) <= 3,
          f"launch_assemble made {len(activities)} device activities")
    res["crc32_words_masked_raw"] = dict(
        max_abs_err=int((g2 - w2).abs().max()),
        ms=cuda_ms(torch, lambda: idat_crc_words(*crc_args), 20),
        plain_ms=cuda_ms(torch, lambda: idat_crc_words_plain(*crc_args), 5),
        launches_per_encode=len(activities), encode_activities=activities,
        # the words of the live chunks read, the tables read once, 36 bytes
        # an image of inputs and CRC; ~3 ops a live byte (table lookup,
        # xor, shift)
        bound=bound(4096 * live_chunks + 4 * (_word_bit_table().size +
                                              _shift_tables().size) + 36 * B,
                    3 * 4096 * live_chunks),
        shape=[B, nw], chunks=K, odd_chunks=bool(K % 2),
        live_chunks=live_chunks, buffer_chunks=B * K)
    check(K % 2 == 1, "the corpus word buffer has an odd chunk count")

    # B10 on decode-style records at the chunked decode's shape for this
    # corpus: sorted 16-bit slots, distinct literal slots, zero-width gaps
    tb = hi.cpu().numpy() + 4 + 16  # zlib stream + adler, CRC + IEND
    nb = 64
    while nb < int(tb.max()):
        nb *= 2
    _, NC, ST = plan_chunks(nb)
    total_slots = H * (1 + W_ * Cc)
    n = NC * ST
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    step = torch.rand((B, n), generator=g, device=dev) < total_slots / n
    outp = torch.clamp(torch.cumsum(step, dim=1), max=total_slots)
    lit = step & (outp < total_slots) & \
        (torch.rand((B, n), generator=g, device=dev) < 0.8)
    sym = torch.randint(0, 256, (B, n), generator=g, device=dev)
    vals = torch.where(lit, sym | 0x100, 0).to(torch.int32)
    nbits = lit.to(torch.int32) << 4
    # int32 slots with shift 4, as the chunked decode's records
    slots = outp.to(torch.int32)
    dep_words = -(-(16 * (total_slots + 1)) // 32) + 1
    g3 = deposit_bits(vals, nbits, slots, dep_words, shift=4)
    w3 = scatter_bits(vals, nbits, outp * 16, dep_words)
    check(torch.equal(g3, w3), "B10 words differ from scatter_bits")
    res["deposit_bits"] = dict(
        max_abs_err=err(g3, w3),
        ms=cuda_ms(torch, lambda: deposit_bits(vals, nbits, slots, dep_words,
                                               shift=4), 20),
        plain_ms=cuda_ms(torch, lambda: scatter_bits(
            vals, nbits, outp * 16, dep_words), 5),
        # vals and slots (4 bytes each) read, words written; ~10 ops a unit
        bound=bound(8 * B * n + 4 * B * dep_words, 10 * B * n),
        shape=[B, n], num_words=dep_words)

    # B3-B6 on the walk8 decode of the corpus's own dynamic-block streams
    pngs = T.encode_batch(imgs, device=DEV)
    Bd, (st_d, lut32, p0_d, zl_d), (words8, _, p0_32, zl8_32), nc = \
        pack_batch(torch, pngs)

    def walk():
        return W.walk_fix8(words8, lut32, p0_32, zl8_32, n_chunks=nc)

    def walk_plain():
        return W.walk_fix8_plain(words8, lut32, p0_32, zl8_32, n_chunks=nc)

    n0 = W.walk_fix8.launches
    g4, w4 = walk(), walk_plain()
    check(W.walk_fix8.launches == n0 + 1, "B3 is not one launch a walk")
    check(not bool(g4[2].any()), "the headline corpus overflows walk8")
    e3 = walk_err(torch, "B3", g4, w4)
    steps_sum = int(g4[1].sum())
    res["walk_fix8"] = dict(
        max_abs_err=e3,
        ms=cuda_ms(torch, walk, 5), plain_ms=cuda_ms(torch, walk_plain, 1),
        bound=walk_bound(words8, lut32, g4, Bd, nc),
        **walk_counts(W, g4), shape=[Bd, nc], recorded_steps=steps_sum)

    records, e_fin, out0, steps, ovf, _ = W.decode_walk8(
        st_d, lut32, p0_d, zl_d, n_chunks=nc)
    check(not bool(ovf.any()), "walk8 overflow on the headline corpus")
    k8 = W.trim_steps(int(steps), records[0].shape[1])
    kw = dict(k8=k8, h=H, bpl=W_ * Cc, c=Cc)
    fin_args = (*records, e_fin, out0)
    g5 = W.finalize_records8(*fin_args, **kw)
    w5 = W.finalize_records8_plain(*fin_args, **kw)
    for a, b, what in zip(g5, w5, ("meta", "metb", "chk")):
        check(torch.equal(a, b), f"B4 {what} differs from plain")
    # rows B4 must read: the recorded steps among its first k8 rows
    read_rows = int(torch.clamp(records[3], max=k8).sum())
    out_rows = Bd * k8 * nc
    res["finalize_records8"] = dict(
        max_abs_err=max(masked_err(a, b) for a, b in zip(g5, w5)),
        ms=cuda_ms(torch, lambda: W.finalize_records8(*fin_args, **kw), 20),
        plain_ms=cuda_ms(torch, lambda: W.finalize_records8_plain(
            *fin_args, **kw), 3),
        **profiler_line(profiled_ms(torch, lambda: W.finalize_records8(
            *fin_args, **kw))),
        # 12 bytes a recorded row read, 8 bytes an output row written, 12
        # bytes a lane read, 12 a check triple written; ~60 ops a recorded
        # row, ~4 an output row
        bound=bound(12 * read_rows + 8 * out_rows + 12 * Bd * nc + 12 * Bd,
                    60 * read_rows + 4 * out_rows),
        shape=[Bd, k8, nc], read_rows=read_rows)

    n_slots = H * W_ * Cc
    meta, metb = g5[:2]  # (B, k8, NC), as finish_decode passes them
    g6 = scatter_packed16(meta, metb, n_slots)
    w6 = scatter_packed16_plain(meta, metb, n_slots)
    check(torch.equal(g6, w6), "B5 raster differs from plain")
    check(torch.equal(scatter_packed16(meta.reshape(Bd, -1),
                                       metb.reshape(Bd, -1), n_slots), w6),
          "B5 on the flattened (B, N) records differs from plain")
    lit_records = int((metb != 0).sum())
    res["scatter_packed16"] = dict(
        max_abs_err=masked_err(g6, w6),
        ms=cuda_ms(torch, lambda: scatter_packed16(meta, metb, n_slots), 20),
        plain_ms=cuda_ms(torch, lambda: scatter_packed16_plain(
            meta, metb, n_slots), 5),
        **profiler_line(profiled_ms(torch, lambda: scatter_packed16(
            meta, metb, n_slots))),
        # the value word of every record read, the slot word of each record
        # that carries a literal, the raster written once; ~8 ops a record
        bound=bound(4 * meta.numel() + 4 * lit_records + 2 * Bd * n_slots,
                    8 * meta.numel()),
        shape=list(meta.shape), n_slots=n_slots, lit_records=lit_records)

    g7 = check_expand(torch, g6, imgs[device_decoded(pngs)],
                      "the headline walk8 decode")
    w7 = expand_plain(g6, h=H, w=W_, c=Cc)
    res["expand"] = dict(
        max_abs_err=masked_err(g7, w7),
        ms=cuda_ms(torch, lambda: expand(g6, h=H, w=W_, c=Cc), 20),
        plain_ms=cuda_ms(torch, lambda: expand_plain(g6, h=H, w=W_, c=Cc), 5),
        # slots read once, bytes written once; ~8 ops a slot
        bound=bound(3 * Bd * n_slots, 8 * Bd * n_slots),
        shape=[Bd, H, W_, Cc], launches_per_call=1,
        tiling=dict(zip(("rows", "strip", "bands", "strips"),
                        expand_tiling(H, W_ * Cc))))
    return kernel_line(res)


def pack_batch(torch, pngs):
    """A batch's dynamic-block streams packed as decode_batch packs them,
    on the card: (images, (stream, lut, p0, zlib_len) as decode_walk8 takes
    them, (words, lut, p0, 8 * zlib_len) int32 as the walks take them,
    lanes an image)."""
    from fpng_tpu_torch.models.decoder import _parse_one, pack_streams
    from fpng_tpu_torch.ops import walk8 as W

    metas = [m for m in map(_parse_one, pngs) if m[7] is not None]
    stream, luts, p0, zl = pack_streams(metas)
    stream, lut32, p0, zl = (torch.from_numpy(a).to(DEV) for a in (
        stream, luts.view(np.int32), p0, zl))
    return (len(metas), (stream, lut32, p0, zl),
            (W.stream_words(stream), lut32, p0.to(torch.int32),
             (zl * 8).to(torch.int32)),
            W.n_chunks(int(zl.max())))


def walk_err(torch, name, got, want, images=None):
    """Hold a walk (B3 or B8) against its plain version: passes, e_fin,
    nst and ovf exact, records up to nst; on `images` (default all) every
    output.  Returns the largest difference (0)."""
    check(int(got[6]) == int(want[6]),
          f"{name} passes {int(got[6])} != plain {int(want[6])}")
    sel = slice(None) if images is None else images
    err = 0
    rows = torch.arange(got[3].shape[1], device=got[3].device)[None, :, None] \
        < want[1][sel][:, None]
    for k, what in enumerate(("e_fin", "nst", "ovf", "posr", "raw0",
                              "raw1")):
        a, b = got[k][sel], want[k][sel]
        if k >= 3:
            a, b = torch.where(rows, a, 0), torch.where(rows, b, 0)
        check(torch.equal(a, b), f"{name} {what} differs from plain")
        err = max(err, int((a.to(torch.int64) - b.to(torch.int64))
                           .abs().max()) if a.numel() else 0)
    return err


def walk_bound(words, lut32, out, Bd, nc):
    """B3's and B8's bound: stream words and LUTs read, a position (4 or 8
    bytes, the walk's dtype) and two record words a recorded step and 12
    bytes and an entry a lane written; ~30 ops a step."""
    steps_sum = int(out[1].sum())
    ps = out[3].element_size()
    return bound(4 * words.numel() + 4 * lut32.numel() +
                 (ps + 8) * steps_sum + (ps + 12) * Bd * nc, 30 * steps_sum)


def walk_counts(W, out):
    """The walk's passes, its launch geometry, and the serial floor the
    design reaches for: passes x the longest walk of a lane, in steps."""
    passes = int(out[6])
    return dict(launches_per_walk=1, passes=passes,
                step_rows=int(out[3].shape[1]),
                max_lane_steps=int(out[1].max()),
                serial_floor_steps=passes * int(out[1].max()),
                occupancy=dict(W.walk_cuda.launch))


def phase_walk8_overflow(torch, T, imgs):
    """B3 on the 32 bpp 1-pass corpus, which overflows walk8: the kernel
    gives the plain version's outputs for every image (an overflowing
    lane's records up to its rows, its exit walked on to its chunk end),
    B8's converged entries and passes, and B8 seeded with its entries
    (resume_seed: the launch the decode chain makes) reads 2 passes to the
    same entries.  The line gives B3's passes beside the unseeded and the
    seeded B8's, and the seeded B8's time (a copy of the seed included:
    the walk writes its entries into the seed)."""
    from fpng_tpu_torch.ops import specdec_tpu as PK
    from fpng_tpu_torch.ops import walk8 as W

    pngs = T.encode_batch(imgs, device=DEV)
    Bd, dec_args, (words, lut32, p0_32, zl8), nc = pack_batch(torch, pngs)

    def walk():
        return W.walk_fix8(words, lut32, p0_32, zl8, n_chunks=nc)

    n0 = W.walk_fix8.launches
    g = walk()
    check(W.walk_fix8.launches == n0 + 1, "B3 is not one launch a walk")
    w = W.walk_fix8_plain(words, lut32, p0_32, zl8, n_chunks=nc)
    live = W._lane_geometry(zl8, nc)[1]
    ovf = (w[2] & live).any(dim=1)
    check(torch.equal((g[2] & live).any(dim=1), ovf),
          "B3 image overflow flags differ")
    check(bool(ovf.any()), "the 32 bpp 1-pass corpus does not overflow")
    err = walk_err(torch, "B3 (overflowing batch)", g, w)
    b8 = PK.walk_fix(words, lut32, p0_32, zl8, n_chunks=nc)
    check(torch.equal(g[0], b8[0]) and int(g[6]) == int(b8[6]),
          "B3's converged entries or passes are not B8's")

    seed = W.resume_seed(*g[3:6], g[1], g[0])

    def resumed():
        return PK.walk_fix(words, lut32, p0_32, zl8, n_chunks=nc,
                           seed=seed.clone())

    r = resumed()
    check(torch.equal(r[0], b8[0]) and int(r[6]) == 2,
          "B8 seeded with B3's entries is not 2 passes to B8's entries")
    err = max(err, walk_err(torch, "B8 (resumed)", r, PK.walk_fix_plain(
        words, lut32, p0_32, zl8, n_chunks=nc, seed=seed.clone())))
    line("walk8_overflow", name="walk_fix8", corpus="real4_1pass",
         shape=[Bd, nc], overflowing_images=int(ovf.sum()),
         b3_passes=int(g[6]), b8_passes=int(b8[6]),
         b8_resumed_passes=int(r[6]), max_abs_err=err,
         ms=cuda_ms(torch, walk, 5), b8_resumed_ms=cuda_ms(torch, resumed, 5),
         bound_ms=walk_bound(words, lut32, g, Bd, nc)[0],
         **walk_counts(W, g))
    B, H, W_, Cc = imgs.shape
    check_expand(torch, pk1_raster(torch, dec_args, nc, H, W_ * Cc, Cc),
                 imgs[device_decoded(pngs)], "the PK=1 decode of the 32 bpp "
                 "1-pass corpus")


def profiler_line(prof):
    """The kernel-line keys of a profiled_ms result."""
    return {"profiler_ms": prof[0], "profiler_kernels": prof[1]}


def kernel_line(res):
    for name, r in res.items():
        if "bound" in r:
            r["bound_ms"], r["bound_by"] = r.pop("bound")
        r.setdefault("library_ms", None)  # None: no single PyTorch call
        line("kernel", name=name, **r)
    return res


def phase_demote(torch, imgs):
    """B7 against its plain version on the cost-check inputs of a 32 bpp
    1-pass batch (the 1-pass tables)."""
    return kernel_line({"demote_mask": b7_times(torch,
                                                b7_inputs(torch, imgs))})


def phase_pk1(torch, T, imgs):
    """B8 and B9 against their plain versions on the decode of a 2-pass
    batch whose streams overflow walk8's 96 step rows: B8 unseeded (as
    with FPNG_TPU_WALK8=0) and seeded with walk8's entries (decode_kernel8's
    seed, as the decode chain resumes), and B9 on each walk's records at
    its own step trim."""
    from fpng_tpu_torch.ops import specdec_tpu as PK
    from fpng_tpu_torch.ops import walk8 as W
    from fpng_tpu_torch.ops.bitpack import (scatter_packed16,
                                            scatter_packed16_plain)

    B, H, W_, Cc = imgs.shape
    pngs = T.encode_batch(imgs, T.FPNG_ENCODE_SLOWER, device=DEV)
    Bd, (st_d, lut32, p0_d, zl_d), (words, _, p0_32, zl8_32), nc = \
        pack_batch(torch, pngs)
    ovf = W.decode_walk8(st_d, lut32, p0_d, zl_d, n_chunks=nc)[4]
    n_ovf = int(ovf.sum())
    check(n_ovf > 0, "the 2-pass corpus does not overflow walk8")
    got8, _, seed8 = W.decode_kernel8(st_d, lut32, p0_d, zl_d, h=H, w=W_,
                                      c=Cc, zlib_len_max=int(zl_d.max()))
    check(got8 is None and seed8 is not None,
          "walk8 does not hand the 2-pass corpus its entries")

    def walk():
        return PK.walk_fix(words, lut32, p0_32, zl8_32, n_chunks=nc)

    def walk_plain():
        return PK.walk_fix_plain(words, lut32, p0_32, zl8_32, n_chunks=nc)

    n0 = PK.walk_fix.launches
    g, w = walk(), walk_plain()
    check(PK.walk_fix.launches == n0 + 1, "B8 is not one launch a walk")
    err = walk_err(torch, "B8", g, w)
    res = {"walk_fix": dict(
        max_abs_err=err, ms=cuda_ms(torch, walk, 3),
        plain_ms=cuda_ms(torch, walk_plain, 1),
        bound=walk_bound(words, lut32, g, Bd, nc), **walk_counts(W, g),
        shape=[Bd, nc], recorded_steps=int(g[1].sum()),
        walk8_overflow_images=n_ovf)}

    def walk_resumed():
        return PK.walk_fix(words, lut32, p0_32, zl8_32, n_chunks=nc,
                           seed=seed8.clone())

    gr = walk_resumed()
    wr = PK.walk_fix_plain(words, lut32, p0_32, zl8_32, n_chunks=nc,
                           seed=seed8.clone())
    check(int(gr[6]) == 2 and torch.equal(gr[0], g[0]),
          "B8 seeded with walk8's entries is not 2 passes to B8's entries")
    res["walk_fix_resumed"] = dict(
        max_abs_err=walk_err(torch, "B8 (resumed)", gr, wr),
        ms=cuda_ms(torch, walk_resumed, 3), plain_ms=cuda_ms(
            torch, lambda: PK.walk_fix_plain(
                words, lut32, p0_32, zl8_32, n_chunks=nc,
                seed=seed8.clone()), 1),
        bound=walk_bound(words, lut32, gr, Bd, nc), **walk_counts(W, gr),
        shape=[Bd, nc], recorded_steps=int(gr[1].sum()))

    def b9(key, tag, walk):
        """B9 (and B5) on the records of one PK=1 walk at its step trim."""
        records, e_fin, out0, steps, _, _ = W.walk_offsets(
            walk, st_d, lut32, p0_d, zl_d, n_chunks=nc)
        k8 = W.trim_steps(int(steps), PK.ST8)
        check(k8 > 8 * W.MAXIT, f"PK=1{tag} trim {k8} within walk8's rows")
        kw = dict(k8=k8, h=H, bpl=W_ * Cc, c=Cc)
        fin_args = (*records, e_fin, out0)
        g5 = PK.finalize_records(*fin_args, **kw)
        w5 = PK.finalize_records_plain(*fin_args, **kw)
        for a, b, what in zip(g5, w5, ("meta", "metb", "chk")):
            check(torch.equal(a, b), f"B9{tag} {what} differs from plain")
        read_rows = int(torch.clamp(records[3], max=k8).sum())
        out_rows = Bd * k8 * nc
        res[key] = dict(
            max_abs_err=max(int((a.to(torch.int64) - b.to(torch.int64))
                                .abs().max()) for a, b in zip(g5, w5)),
            ms=cuda_ms(torch, lambda: PK.finalize_records(*fin_args, **kw),
                       10),
            plain_ms=cuda_ms(torch, lambda: PK.finalize_records_plain(
                *fin_args, **kw), 2),
            **profiler_line(profiled_ms(torch, lambda: PK.finalize_records(
                *fin_args, **kw))),
            # as finalize_records8: 12 bytes a recorded row read, 8 an
            # output row written, 12 a lane read, 12 a check triple written
            bound=bound(12 * read_rows + 8 * out_rows + 12 * Bd * nc +
                        12 * Bd, 60 * read_rows + 4 * out_rows),
            shape=[Bd, k8, nc], read_rows=read_rows)
        raster = scatter_packed16(g5[0], g5[1], H * W_ * Cc)
        check(torch.equal(raster, scatter_packed16_plain(g5[0], g5[1],
                                                         H * W_ * Cc)),
              f"B5 on the PK=1{tag} records differs from plain")
        check_expand(torch, raster, imgs[device_decoded(pngs)],
                     f"the PK=1{tag} decode of the 24 bpp 2-pass corpus")
        return k8

    k8 = b9("finalize_records", "", PK.walk_fix)
    k8r = b9("finalize_records_resumed", " (resumed)",
             functools.partial(PK.walk_fix, seed=seed8.clone()))
    check(k8r <= k8, f"the resumed walk's trim {k8r} past the walk's {k8}")
    return kernel_line(res)


def device_decoded(pngs):
    """Indices of the files that take a device decode (not stored)."""
    return [i for i, p in enumerate(pngs) if not is_stored(p)]


def check_expand(torch, raster, imgs, what):
    """B6 on a decode's raster: one launch, bit-exact against expand_plain,
    and the corpus's pixels."""
    from fpng_tpu_torch.ops.expand import expand, expand_plain

    B, H, W_, Cc = imgs.shape
    n0 = expand.launches
    got = expand(raster, h=H, w=W_, c=Cc)
    check(expand.launches == n0 + 1, f"B6 on {what}: not one launch")
    check(torch.equal(got, expand_plain(raster, h=H, w=W_, c=Cc)),
          f"B6 on {what} differs from plain")
    check(np.array_equal(got.cpu().numpy(), imgs),
          f"B6 on {what}: pixels differ from the corpus")
    return got


def pk1_raster(torch, dec_args, nc, h, bpl, c):
    """The PK=1 chain (B8, B9, B5) up to B6's input raster."""
    from fpng_tpu_torch.ops import specdec_tpu as PK
    from fpng_tpu_torch.ops import walk8 as W

    records, e_fin, out0, steps, _, _ = W.walk_offsets(
        PK.walk_fix, *dec_args, n_chunks=nc)
    k8 = W.trim_steps(int(steps), PK.ST8)
    meta, metb, _ = PK.finalize_records(*records, e_fin, out0, k8=k8, h=h,
                                        bpl=bpl, c=c)
    return b5_checked(torch, meta, metb, h * bpl)


def walk8_raster(torch, dec_args, nc, h, bpl, c):
    """The walk8 chain (B3, B4, B5) up to B6's input raster."""
    from fpng_tpu_torch.ops import walk8 as W

    records, e_fin, out0, steps, ovf, _ = W.decode_walk8(*dec_args,
                                                         n_chunks=nc)
    check(not bool(ovf.any()), "walk8 overflow")
    k8 = W.trim_steps(int(steps), records[0].shape[1])
    meta, metb, _ = W.finalize_records8(*records, e_fin, out0, k8=k8, h=h,
                                        bpl=bpl, c=c)
    return b5_checked(torch, meta, metb, h * bpl)


def b5_checked(torch, meta, metb, n_slots):
    """B5 on (B, k8, NC) records, held against its plain version."""
    from fpng_tpu_torch.ops.bitpack import (scatter_packed16,
                                            scatter_packed16_plain)

    raster = scatter_packed16(meta, metb, n_slots)
    check(torch.equal(raster, scatter_packed16_plain(meta, metb, n_slots)),
          f"B5 on {list(meta.shape)} records differs from plain")
    return raster


def expand_times(torch, T, bench):
    """B6 on the walk8 decode rasters of the headline and 4K corpora: its
    CUDA-event time, launches a call and bound, each raster held against
    expand_plain and the corpus's pixels."""
    from fpng_tpu_torch.ops.expand import expand, expand_plain

    out = {}
    for name, imgs in (("headline", bench.make_corpus("real3")),
                       ("4k", bench.make_corpus_4k())):
        B, H, W_, Cc = imgs.shape
        pngs = T.encode_batch(imgs, device=DEV)
        _, dargs, _, nc = pack_batch(torch, pngs)
        raster = walk8_raster(torch, dargs, nc, H, W_ * Cc, Cc)
        n0 = expand.launches
        got = expand(raster, h=H, w=W_, c=Cc)
        per_call = expand.launches - n0
        check(torch.equal(got, expand_plain(raster, h=H, w=W_, c=Cc)) and
              np.array_equal(got.cpu().numpy(), imgs[device_decoded(pngs)]),
              f"B6 on the {name} raster")
        out[name] = dict(
            ms=cuda_ms(torch, lambda: expand(raster, h=H, w=W_, c=Cc), 20),
            launches_per_call=per_call,
            bound_ms=bound(3 * raster.numel(), 8 * raster.numel())[0],
            shape=[int(got.shape[0]), H, W_, Cc])
    return out


def decode_spans(torch, T, pngs, Cc, runs=3):
    """decode_batch runs with the decoder's stage spans on
    (models/decoder.py:_span; host-clock spans that do not synchronise, so
    a stage that queues card work is charged the host's time to queue it,
    and the wait for the readback falls between the spans): per run its
    wall time, each stage, and rest = wall - the stages (Python and that
    wait between the spans), all from that one run."""
    from fpng_tpu_torch.models.decoder import decode_batch

    out = []
    for _ in range(runs):
        decode_batch.spans = {}
        t = time.perf_counter()
        T.decode_batch(pngs, Cc, device=DEV)
        wall = time.perf_counter() - t
        st = {f"{k}_s": v for k, v in decode_batch.spans.items()}
        decode_batch.spans = None
        out.append(dict(wall_s=wall, **st, rest_s=wall - sum(st.values())))
    return out


def profile_device(torch, fn):
    """One call of fn() under torch.profiler: (wall s, device busy s,
    device idle share, the five device kernels with the most time, s by
    kernel name).  A trace that holds no device activity at all (the
    profiler now and then drops a whole trace) is taken again, up to three
    calls in all."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        spans, per_name = [], {}
        for e in prof.events():
            if getattr(e, "device_type", None) != \
                    torch.autograd.DeviceType.CUDA:
                continue
            s, t_end = e.time_range.start, e.time_range.end
            spans.append((s, t_end))
            per_name[e.name] = per_name.get(e.name, 0.0) + (t_end - s) / 1e6
        if spans:
            break
    if not spans:
        return wall, None, None, [], per_name
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, t_end in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, t_end
        else:
            cur_e = max(cur_e, t_end)
    busy = (busy + cur_e - cur_s) / 1e6
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:5]
    return wall, busy, 1 - busy / wall, [[k[:60], v] for k, v in top], \
        per_name


def profile_decode(torch, T, pngs, Cc):
    """One decode under torch.profiler: (wall s, device busy s, device
    idle share, the five device kernels with the most time)."""
    return profile_device(torch, lambda: T.decode_batch(pngs, Cc,
                                                        device=DEV))[:4]


def profile_encode(torch, T, imgs):
    """One encode_batch under torch.profiler (after a warm-up): wall and
    device busy time, idle share, the five device operations with the
    most time, and the shares of the busy time of B1 (encfuse_kernel) and
    B2 (idat_crc_kernel)."""
    T.encode_batch(imgs, device=DEV)
    wall, busy, idle, top, per = profile_device(
        torch, lambda: T.encode_batch(imgs, device=DEV))
    check(busy, "the profiled encode recorded no device time")

    def share(tag):
        return sum(v for k, v in per.items() if tag in k) / busy

    return dict(wall_s=wall, device_busy_s=busy, device_idle_share=idle,
                top_device=top, device_ops=len(per),
                b1_share=share("encfuse_kernel"),
                b2_share=share("idat_crc_kernel"))


def walk_split(torch, pngs):
    """Host-clock seconds of the two device decodes of one packed batch:
    the walk8 attempt (decode_kernel8; its converged entries when it
    overflows) and the PK=1 decode, resumed from those entries as the
    decode chain does, each ending in a synchronise."""
    from fpng_tpu_torch.models.decoder import _parse_one, pack_streams
    from fpng_tpu_torch.ops.specdec_tpu import decode_kernel_pk1
    from fpng_tpu_torch.ops.walk8 import decode_kernel8

    metas = [m for m in map(_parse_one, pngs) if m[7] is not None]
    _, w, h, c, *_ = metas[0]
    stream, luts, p0, zl = pack_streams(metas)
    args = [torch.from_numpy(a.astype(t)).to(DEV) for a, t in zip(
        (stream, luts, p0, zl), (np.uint8, np.int64, np.int64, np.int64))]
    out, kw = {}, dict(h=h, w=w, c=c, zlib_len_max=int(zl.max()))
    for name, fn in (("walk8_s", decode_kernel8),
                     ("pk1_s", decode_kernel_pk1)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn(*args, **kw)
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t
        if len(res) == 3 and res[2] is not None:  # walk8's entries
            kw["seed"] = res[2]
    return out


def make_large_raster(H=6144, W=7680, noise=True):
    """(1, H, W, 3): a mosaic of the 3-channel 256 x 256 tiles, built as
    bench.make_corpus_4k builds its mosaic (rng seed 7), with noise in
    [0, 8) on every byte unless noise is False, so that the tokens average
    over 2.7 bits and the chunked walk's 768 steps a 2048-bit chunk hold
    (6144 x 7680 x 3 is a raster of 141.6 M bytes, past 2^27)."""
    from fpng_tpu_torch.train import synthetic_corpus

    tiles = [np.ascontiguousarray(t[:256, :256])
             for t in synthetic_corpus(3, size=256)]
    rng = np.random.default_rng(7)
    img = np.concatenate([
        np.concatenate([tiles[rng.integers(0, len(tiles))]
                        for _ in range(-(-W // 256))], axis=1)[:, :W]
        for _ in range(-(-H // 256))], axis=0)[:H]
    if noise:
        img += rng.integers(0, 8, img.shape, dtype=np.uint8)  # wraps mod 256
    return img[None]


EDGE = (5824, 7680)  # the tallest 7680 x 3 raster fpng_tpu's walk gate admits


def phase_walk_gate_edge(torch, T, reset, read):
    """The tallest 4K-wide raster fpng_tpu's walk gate admits, 1 x 5824 x
    7680 x 3 (134.2 M slots: past fpng_tpu's VMEM cap of 28.3 M slots, which
    the port drops), make_large_raster's mosaic without the noise; the
    port's own limit (ops/walk8.fits) admits eight times as many rows.
    decode_batch on walk8, on PK=1 (FPNG_TPU_WALK8=0) and on the chunked
    decode (the limit patched to refuse), each bit-exact against the input
    and the zlib check, the walks' output against the chunked one, each path
    through its kernels with no host hand-off; then the walk8 and PK=1
    decodes stage by stage with each stage's peak device bytes
    (tools/decode_memory.stage_peaks), and B3, B4, B5, B6 and B8 timed on
    the raster's streams (B5 and B6 held against their plain versions)."""
    from fpng_tpu_torch.models import decoder as TD
    from fpng_tpu_torch.models.decoder import decode_batch
    from fpng_tpu_torch.ops import specdec_tpu as PK
    from fpng_tpu_torch.ops import walk8 as WK
    from fpng_tpu_torch.ops.bitpack import scatter_packed16
    from fpng_tpu_torch.ops.expand import expand
    from fpng_tpu_torch.tools import decode_memory as DM

    H, W = EDGE
    img = make_large_raster(H, W, noise=False)
    Cc = img.shape[3]
    bpl = W * Cc
    # fpng_tpu's gate stops here (8 rows more allocate past 2^27 slots);
    # the port's limit, h * (bpl + 1) < 2^30, at port_edge rows
    port_edge = ((1 << 30) - 1) // (bpl + 1)
    check(WK.fits(H, bpl) and WK.fits(H + 8, bpl) and
          WK.fits(port_edge, bpl) and not WK.fits(port_edge + 1, bpl),
          f"{H} x {bpl}: the walk path's limit is not h * (bpl + 1) < 2^30")
    reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pngs, enc_s = timed(lambda: T.encode_batch(img, device=DEV))
    enc_peak = torch.cuda.max_memory_allocated()
    enc_launches = {k: v for k, v in read().items() if v}
    check(enc_launches == {"encode_bits_fused": 1,
                           "crc32_words_masked_raw": 1},
          f"edge raster encode launches {enc_launches}")
    check(not is_stored(pngs[0]), "the edge raster was stored")
    check(zlib_check(pngs[0], img[0]), "edge raster zlib check")
    path_kernels = {
        "walk8": ("walk_fix8", "finalize_records8", "scatter_packed16",
                  "expand"),
        "pk1": ("walk_fix", "finalize_records", "scatter_packed16", "expand"),
        "chunked": ("deposit_bits",)}
    outs, res = {}, {}
    walk_gate = TD.fits
    try:
        for path, kernels in path_kernels.items():
            if path == "pk1":
                os.environ["FPNG_TPU_WALK8"] = "0"
            if path == "chunked":
                TD.fits = lambda h, bpl: False
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.memory_allocated()
            reset()
            (sts, got), dec_s = timed(lambda: T.decode_batch(pngs, Cc,
                                                             device=DEV))
            launches = {k: v for k, v in read().items() if v}
            os.environ.pop("FPNG_TPU_WALK8", None)
            check(sts == [0] and np.array_equal(got[0], img[0]),
                  f"edge raster on {path}: status {sts} or pixels differ")
            want = {"walk8": 0, "pk1": 0, "chunked": 0, path: 1}
            check(decode_batch.paths == want and
                  decode_batch.host_handoffs == 0,
                  f"edge raster on {path}: paths {decode_batch.paths}, "
                  f"{decode_batch.host_handoffs} host hand-offs")
            check(launches == {k: 1 for k in kernels},
                  f"edge raster on {path}: launches {launches}")
            outs[path] = got[0]
            res[path] = dict(
                decode_s=dec_s,
                passes=(WK.walk_fix8.passes if path == "walk8" else
                        PK.walk_fix.passes if path == "pk1" else None),
                peak_device_gb=torch.cuda.max_memory_allocated() / 1e9,
                start_device_gb=start / 1e9)
    finally:
        TD.fits = walk_gate
        os.environ.pop("FPNG_TPU_WALK8", None)
    for path in ("walk8", "pk1"):
        check(np.array_equal(outs[path], outs["chunked"]),
              f"edge raster: {path} output differs from the chunked one")
    del outs, got

    # the kernels at this raster, on its own streams
    Bd, dargs, wargs, nc = pack_batch(torch, pngs)
    n_slots = H * bpl
    for path in ("walk8", "pk1"):
        got, res[path]["stages"] = DM.stage_peaks(torch, dargs, nc, H, W, Cc,
                                                  path)
        check(np.array_equal(got[0].cpu().numpy(), img[0]),
              f"edge raster's {path} stages: pixels differ")
        del got
    k = {}
    g3 = WK.walk_fix8(*wargs, n_chunks=nc)
    k["walk_fix8"] = dict(ms=cuda_ms(torch, lambda: WK.walk_fix8(
        *wargs, n_chunks=nc), 3), bound_ms=walk_bound(*wargs[:2], g3, Bd,
                                                     nc)[0],
        passes=int(g3[6]), lanes=nc)
    del g3
    records, e_fin, out0, steps, ovf, _ = WK.decode_walk8(*dargs, n_chunks=nc)
    check(not bool(ovf.any()), "the edge raster overflows walk8")
    k8 = WK.trim_steps(int(steps), records[0].shape[1])
    kw = dict(k8=k8, h=H, bpl=bpl, c=Cc)
    fin = (*records, e_fin, out0)
    meta, metb, _ = WK.finalize_records8(*fin, **kw)
    k["finalize_records8"] = dict(ms=cuda_ms(
        torch, lambda: WK.finalize_records8(*fin, **kw), 3), k8=k8)
    del records, fin
    raster = b5_checked(torch, meta, metb, n_slots)
    k["scatter_packed16"] = dict(
        ms=cuda_ms(torch, lambda: scatter_packed16(meta, metb, n_slots), 3),
        bound_ms=bound(4 * meta.numel() + 4 * int((metb != 0).sum()) +
                       2 * n_slots, 8 * meta.numel())[0])
    del meta, metb
    check_expand(torch, raster, img, "the edge raster's walk8 decode")
    k["expand"] = dict(
        ms=cuda_ms(torch, lambda: expand(raster, h=H, w=W, c=Cc), 3),
        bound_ms=bound(3 * n_slots, 8 * n_slots)[0])
    del raster
    g8 = PK.walk_fix(*wargs, n_chunks=nc)
    k["walk_fix"] = dict(ms=cuda_ms(torch, lambda: PK.walk_fix(
        *wargs, n_chunks=nc), 3), bound_ms=walk_bound(*wargs[:2], g8, Bd,
                                                     nc)[0],
        passes=int(g8[6]))
    del g8, dargs, wargs
    torch.cuda.empty_cache()
    zlen = int.from_bytes(pngs[0][50:54], "big")
    line("walk_gate_edge", batch=list(img.shape), port_edge_rows=port_edge,
         raster_bytes=H * (1 + bpl), slots=H * bpl, zlib_bytes=zlen,
         bits_per_raster_byte=8 * zlen / (H * (1 + bpl)), encode_s=enc_s,
         encode_peak_device_gb=enc_peak / 1e9, paths=res, kernels=k)


def phase_large_raster_2g(torch, T, reset, read):
    """One raster past 2^27 bytes, past fpng_tpu's walk gate and within the
    port's limit: encode_batch, then decode_batch on the walk chain (walk8,
    or PK=1 after an overflow) and on the chunked decode (the limit patched
    to refuse: B10 with 64-bit record offsets), no host hand-off, the
    pixels and the zlib check."""
    from fpng_tpu_torch.models import decoder as TD
    from fpng_tpu_torch.models.decoder import decode_batch
    from fpng_tpu_torch.ops.walk8 import fits

    img = make_large_raster()
    _, H, W_, Cc = img.shape
    raster_bytes = H * (1 + W_ * Cc)
    check(raster_bytes >= 1 << 27 and fits(H, W_ * Cc),
          "the large raster is not past 2^27 bytes within the walk's limit")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    pngs, enc_s = timed(lambda: T.encode_batch(img, device=DEV))
    enc_peak = torch.cuda.max_memory_allocated()
    enc_launches = read()
    check(not is_stored(pngs[0]), "the large raster was stored")
    check(zlib_check(pngs[0], img[0]), "large raster zlib check")
    check(enc_launches["crc32_words_masked_raw"] == 1 and
          enc_launches["encode_bits_fused"] == 1,
          f"large raster encode launches {enc_launches}")
    res = {}
    walk_limit = TD.fits
    try:
        for path in ("walk", "chunked"):
            if path == "chunked":
                TD.fits = lambda h, bpl: False
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset()
            (sts, outs), dec_s = timed(lambda: T.decode_batch(pngs, Cc,
                                                              device=DEV))
            launches = {k: v for k, v in read().items() if v}
            paths, hand = dict(decode_batch.paths), decode_batch.host_handoffs
            check(sts == [0] and np.array_equal(outs[0], img[0]),
                  f"large raster on {path}: status {sts}")
            check(hand == 0 and (paths["chunked"] == 1) == (path == "chunked")
                  and sum(paths.values()) == 1,
                  f"large raster on {path}: paths {paths}, {hand} host "
                  "hand-offs")
            check(path == "walk" or launches == {"deposit_bits": 1},
                  f"large raster chunked launches {launches}")
            res[path] = dict(decode_s=dec_s, paths=paths, launches=launches,
                             peak_device_gb=torch.cuda.max_memory_allocated()
                             / 1e9)
    finally:
        TD.fits = walk_limit
    b1_checked(torch, b1_inputs(torch, img), "large_raster_2g")
    zlen = int.from_bytes(pngs[0][50:54], "big")
    line("large_raster_2g", batch=list(img.shape), raster_bytes=raster_bytes,
         zlib_bytes=zlen, bits_per_raster_byte=8 * zlen / raster_bytes,
         encode_s=enc_s, encode_peak_device_gb=enc_peak / 1e9, decodes=res,
         b1_bit_exact=True)


GLOBE = (10800, 21600)  # the whole globe at 1 arc-minute (bmng21600)


def globe_raster():
    """(1, 10800, 21600, 3): the globe_rgb.decode cell's first content call
    (pngbench/content/mosaic.py: the 40 synthetic tiles in the cell's fixed
    arrangement)."""
    from pngbench import tiles

    bank = tiles.bank(3, 256, tiles.N_CLASSES)
    return tiles.mosaic_batch(bank, 1, *GLOBE, np.random.default_rng(0x4B4B))


def phase_globe(torch, T, reset, read):
    """The whole-globe raster, 1 x 10800 x 21600 x 3 (699.85 M bytes, past
    fpng_tpu's gate, a stream past 2^31 bits: 64-bit positions and bit
    counts): encode_batch on the card, zlib and pngbench's plain reference
    (pngref.read) on the file; decode_batch on walk8 (the plan's default),
    on PK=1 (FPNG_TPU_WALK8=0) where decode_bytes says PK=1 fits the card's
    free memory (else the plan must take the chunked decode, and does), and
    on the chunked decode (the limit patched), each bit-exact, no host
    hand-off, with its time and peak; then the walk8 and PK=1 decodes stage
    by stage (tools/decode_memory.stage_peaks) against decode_bytes, the
    chunked decode's peak against chunked_bytes, B3 and B4 at 64-bit
    positions against their plain versions (B3 timed), and B1 against its
    plain version in slices."""
    from fpng_tpu_torch.models import decoder as TD
    from fpng_tpu_torch.models.decoder import decode_batch
    from fpng_tpu_torch.ops import specdec as SD
    from fpng_tpu_torch.ops import specdec_tpu as PK
    from fpng_tpu_torch.ops import walk8 as WK
    from fpng_tpu_torch.tools import decode_memory as DM
    from pngbench import pngref

    t_all = time.perf_counter()
    img, make_s = timed(globe_raster)
    H, W = GLOBE
    Cc = img.shape[3]
    bpl = W * Cc
    check(WK.fits(H, bpl) and H * (bpl + 1) == 699_850_800,
          "the globe is not within the walk path's limit")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    pngs, enc_s = timed(lambda: T.encode_batch(img, device=DEV))
    enc_peak = torch.cuda.max_memory_allocated()
    enc_launches = {k: v for k, v in read().items() if v}
    check(enc_launches == {"encode_bits_fused": 1,
                           "crc32_words_masked_raw": 1},
          f"globe encode launches {enc_launches}")
    check(not is_stored(pngs[0]), "the globe was stored")
    (ref_ok, ref_s) = timed(lambda: np.array_equal(pngref.read(pngs[0]),
                                                   img[0]))
    check(ref_ok and zlib_check(pngs[0], img[0]),
          "the globe's file does not read back to its raster")
    zlen = pngref.idat_bytes(pngs[0])
    nc = WK.n_chunks(zlen)
    pdt = WK.pos_dtype(nc)
    models = {t: WK.decode_bytes(1, nc, st, H, bpl)
              for t, st in (("walk8", 8 * WK.MAXIT), ("pk1", PK.ST8))}
    torch.cuda.empty_cache()
    budget = TD._free_bytes(torch.device(DEV))
    pk1_fits = models["pk1"] <= budget - H * bpl
    outs, res = {}, {}
    walk_limit = TD.fits
    try:
        for path in ("walk8", "pk1", "chunked"):
            if path == "pk1":
                os.environ["FPNG_TPU_WALK8"] = "0"
            if path == "chunked":
                TD.fits = lambda h, bpl: False
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.memory_allocated()
            reset()
            try:
                (sts, got), dec_s = timed(lambda: T.decode_batch(
                    pngs, Cc, device=DEV))
            except torch.OutOfMemoryError as e:  # reported, then failed
                res[path] = dict(error=str(e).splitlines()[0])
                continue
            launches = {k: v for k, v in read().items() if v}
            os.environ.pop("FPNG_TPU_WALK8", None)
            took = "chunked" if path == "pk1" and not pk1_fits else path
            want = {"walk8": 0, "pk1": 0, "chunked": 0, took: 1}
            check(sts == [0] and np.array_equal(got[0], img[0]),
                  f"globe on {path}: status {sts} or pixels differ")
            check(decode_batch.paths == want and
                  decode_batch.host_handoffs == 0,
                  f"globe on {path}: paths {decode_batch.paths}, "
                  f"{decode_batch.host_handoffs} host hand-offs")
            check(path != "pk1" or pk1_fits or not launches.get("walk_fix"),
                  "PK=1 launched where decode_bytes says it cannot fit")
            outs[path] = got[0]
            res[path] = dict(
                decode_s=dec_s, took=took, launches=launches,
                passes=(WK.walk_fix8.passes if path == "walk8" else
                        PK.walk_fix.passes if took == "pk1" else None),
                peak_device_gb=torch.cuda.max_memory_allocated() / 1e9,
                start_device_gb=start / 1e9)
            del got
    finally:
        TD.fits = walk_limit
        os.environ.pop("FPNG_TPU_WALK8", None)
    for path in ("walk8", "pk1"):
        check(path not in outs or "chunked" not in outs or
              np.array_equal(outs[path], outs["chunked"]),
              f"globe: {path} output differs from the chunked one")
    del outs

    # each walk tier stage by stage, and the chunked decode, against the
    # models
    torch.cuda.empty_cache()
    Bd, dargs, wargs, _ = pack_batch(torch, pngs)
    nb = dargs[0].shape[1]
    models["chunked"] = SD.chunked_bytes(1, nb, H, W, Cc)
    stages = {}
    for tier in ("walk8", "pk1"):
        if tier == "pk1" and not pk1_fits:
            continue
        got, peaks = DM.stage_peaks(torch, dargs, nc, H, W, Cc, tier)
        check(np.array_equal(got[0].cpu().numpy(), img[0]),
              f"globe's {tier} stages: pixels differ")
        del got
        top = max(v for k, v in peaks.items() if k != "k8")
        stages[tier] = dict(peaks, model_bytes=models[tier], peak_bytes=top,
                            ratio=models[tier] / top)
        check(models[tier] >= top, f"globe {tier}: model {models[tier]} B "
              f"under the measured {top} B")
        torch.cuda.empty_cache()
    s_bits, lanes, steps = SD.plan_chunks(nb)
    lut64 = dargs[1].to(torch.int64)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    got, ok, ovf = SD.decode_kernel(dargs[0], lut64, dargs[2], dargs[3], h=H,
                                    w=W, c=Cc, n_chunks=lanes,
                                    chunk_bits=s_bits, max_steps=steps)
    torch.cuda.synchronize()
    top = torch.cuda.max_memory_allocated() - start
    check(bool(ok.all()) and not bool(ovf.any()) and
          np.array_equal(got[0].cpu().numpy(), img[0]),
          "globe's chunked decode: pixels differ")
    del got, ok, ovf, lut64
    torch.cuda.empty_cache()
    stages["chunked"] = dict(lanes=lanes, step_rows=steps,
                             model_bytes=models["chunked"], peak_bytes=top,
                             ratio=models["chunked"] / top)
    check(models["chunked"] >= top, f"globe chunked: model "
          f"{models['chunked']} B under the measured {top} B")

    # B3 and B4 at 64-bit positions against their plain versions
    words, lut32 = wargs[:2]  # pack_batch's int32 p0 and zl8 would wrap
    w64 = (words, lut32, dargs[2].to(pdt), (dargs[3] * 8).to(pdt))
    g3 = WK.walk_fix8(*w64, n_chunks=nc)
    w3 = WK.walk_fix8_plain(*w64, n_chunks=nc)
    check(g3[3].dtype == w3[3].dtype == torch.int64,
          "the globe's walk records are not int64")
    err3 = walk_err(torch, "B3 (globe, 64-bit positions)", g3, w3)
    del w3
    torch.cuda.empty_cache()
    b3 = dict(max_abs_err=err3,
              ms=cuda_ms(torch, lambda: WK.walk_fix8(*w64, n_chunks=nc), 3),
              bound_ms=walk_bound(words, lut32, g3, Bd, nc)[0],
              passes=int(g3[6]), max_lane_steps=int(g3[1].max()),
              overflow=bool(g3[2].any()))
    del g3, w64
    torch.cuda.empty_cache()
    records, e_fin, out0, steps, ovf, _ = WK.decode_walk8(*dargs,
                                                          n_chunks=nc)
    check(not bool(ovf.any()), "the globe overflows walk8")
    k8 = WK.trim_steps(int(steps), records[0].shape[1])
    kw = dict(k8=k8, h=H, bpl=bpl, c=Cc)
    g4 = WK.finalize_records8(*records, e_fin, out0, **kw)
    w4 = WK.finalize_records8_plain(*records, e_fin, out0, **kw)
    check(g4[2].dtype == torch.int64, "the globe's check triple is not int64")
    for a, b, what in zip(g4, w4, ("meta", "metb", "chk")):
        check(torch.equal(a, b),
              f"B4 {what} differs from plain (globe, 64-bit positions)")
    del g4, w4
    b4 = dict(k8=k8, ms=cuda_ms(torch, lambda: WK.finalize_records8(
        *records, e_fin, out0, **kw), 3))
    del records, e_fin, out0, dargs, wargs
    torch.cuda.empty_cache()
    b1_checked(torch, b1_inputs(torch, img), "globe", units=1 << 26)
    torch.cuda.empty_cache()
    line("globe", batch=list(img.shape), raster_bytes=H * (1 + bpl),
         zlib_bytes=zlen, lanes=nc, positions=str(pdt),
         bits_per_raster_byte=8 * zlen / (H * (1 + bpl)), make_s=make_s,
         encode_s=enc_s, encode_peak_device_gb=enc_peak / 1e9,
         pngref_s=ref_s, budget_bytes=budget, pk1_fits=pk1_fits,
         models=models, paths=res, stages=stages, walk_fix8=b3,
         finalize_records8=b4, b3_b4_b1_bit_exact=True,
         seconds=time.perf_counter() - t_all)
    check(not [p for p, r in res.items() if "error" in r],
          f"globe: a decode ran out of card memory: {res}")


def model_lines(case, calls, h, bpl):
    """A line a walk tier of a memory_plan case: each of its decodes'
    bytes by ops/walk8.decode_bytes beside its measured peak
    (tools/decode_memory.traced_calls), each model at least the peak and at
    most 1.5 times it."""
    from fpng_tpu_torch.ops import specdec_tpu as PK
    from fpng_tpu_torch.ops import walk8 as WK

    for tier, ST in (("walk8", 8 * WK.MAXIT), ("pk1", PK.ST8)):
        rows = []
        for c in calls:
            if c["tier"] != tier:
                continue
            model = WK.decode_bytes(c["images"], c["lanes"], ST, h, bpl,
                                    finish=c["finished"])
            ratio = model / c["peak"]
            check(1.0 <= ratio <= 1.5, f"memory_plan case {case}, {tier}: "
                  f"model {model} B against a peak of {c['peak']} B")
            rows.append(dict(images=c["images"], lanes=c["lanes"],
                             finished=c["finished"], model_bytes=model,
                             peak_bytes=c["peak"], ratio=ratio))
        if rows:
            line("memory_model", case=case, tier=tier, decodes=rows)


def phase_memory_plan(torch, T, reset, read):
    """Groups past what one walk decode can hold on the card, through
    decode_batch, each image bit-exact against its input and the zlib
    check (tools/decode_memory's cases):
      A: twelve 1 x 5824 x 7680 x 3 edge rasters on PK=1 (FPNG_TPU_WALK8=0),
         about 100 GB unsplit: at least two sub-batches, the peak under the
         card's memory;
      B: 2160 x 3840 x 4 frames of 1-pass mosaics, over 200 MB of zlib,
         walk8 -> PK=1: one walk8 overflow per sub-batch that overflowed.
    No host hand-off; each decode's modelled bytes against its peak
    (model_lines)."""
    from fpng_tpu_torch.models.decoder import decode_batch
    from fpng_tpu_torch.tools import decode_memory as DM

    total = torch.cuda.get_device_properties(0).total_memory
    for case, make in (("a", DM.case_a), ("b", DM.case_b)):
        t0 = time.perf_counter()
        imgs, pngs = make(DEV)
        h, w, c = imgs[0].shape
        zlib_bytes = sum(map(DM._zlib_len, pngs))
        check(not any(map(is_stored, pngs)) and
              all(zlib_check(p, i) for p, i in zip(pngs, imgs)),
              f"memory_plan case {case}: a file is stored or fails zlib")
        check(case == "a" or zlib_bytes > DM.CASE_B_ZLIB,
              f"memory_plan case b: {zlib_bytes} bytes of zlib")
        if case == "a":
            os.environ["FPNG_TPU_WALK8"] = "0"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        reset()
        try:
            with DM.traced_calls(torch) as calls:
                (sts, outs), dec_s = timed(lambda: T.decode_batch(
                    pngs, c, device=DEV))
        finally:
            os.environ.pop("FPNG_TPU_WALK8", None)
        top = max([k["top"] for k in calls] +
                  [torch.cuda.max_memory_allocated()])
        launches = read()
        sub, ovf = decode_batch.sub_batches, decode_batch.walk8_overflows
        walk8 = [k for k in calls if k["tier"] == "walk8"]
        pk1 = [k for k in calls if k["tier"] == "pk1"]
        check(sts == [0] * len(imgs) and all(
            np.array_equal(o, i) for o, i in zip(outs, imgs)),
            f"memory_plan case {case}: statuses {sts} or pixels differ")
        check(top < total, f"memory_plan case {case}: peak {top} B")
        check(decode_batch.host_handoffs == 0 and
              decode_batch.paths == {"walk8": 0, "pk1": 1, "chunked": 0},
              f"memory_plan case {case}: paths {decode_batch.paths}")
        check(launches["walk_fix8"] == len(walk8) and
              launches["walk_fix"] == launches["finalize_records"] ==
              len(pk1), f"memory_plan case {case}: launches {launches}")
        if case == "a":
            check(sub >= 2 and not walk8 and len(pk1) == sub,
                  f"memory_plan case a: {sub} sub-batches, {calls}")
        else:
            check(sub == len(walk8) and ovf >= 1 and
                  ovf == sum(not k["finished"] for k in walk8) ==
                  len(pk1), f"memory_plan case b: {sub} sub-batches, "
                  f"{ovf} walk8 overflows, {calls}")
        line("memory_plan", case=case, batch=[len(imgs), h, w, c],
             zlib_bytes=zlib_bytes, decode_s=dec_s, sub_batches=sub,
             sub_batch_images=[k["images"] for k in pk1],
             walk8_overflows=ovf, start_bytes=start, peak_bytes=top,
             card_bytes=total, seconds=time.perf_counter() - t0)
        model_lines(case, calls, h, w * c)
        del imgs, pngs, sts, outs
        torch.cuda.empty_cache()


def shape_image(h, w, ch):
    """Random bytes with the top half flat, seeded by the shape (as
    tests/test_torch_shapes.py fills its cases)."""
    img = np.random.default_rng([h, w, ch]).integers(0, 256, (h, w, ch),
                                                     dtype=np.uint8)
    img[:max(1, h // 2)] = img[0, 0]
    return img


def phase_extreme_shapes(torch, T, reset, read):
    """The eight shapes at 3 and 4 channels, 1-pass and 2-pass, and
    forced-stored at 1 x 8193 x 3: encode_batch on the card byte-identical
    to the port's CPU run, decode_batch on the card bit-exact with status 0
    and on the path tests/test_torch_shapes.py pins for the CPU run: the
    tall shapes on PK=1 after a walk8 overflow (walk8 holds them at 24 bpp
    1-pass), the others on walk8, 1 x 1 and forced-stored stored."""
    from fpng_tpu_torch.models.decoder import decode_batch

    cases = [(h, w, ch, flags) for h, w in SHAPES for ch in (3, 4)
             for flags in (0, T.FPNG_ENCODE_SLOWER)] + \
        [(1, 8193, 3, T.FPNG_FORCE_UNCOMPRESSED)]
    reset()
    t = time.perf_counter()
    taken = []
    for h, w, ch, flags in cases:
        what = f"{h} x {w} x {ch}, flags {flags}"
        img = shape_image(h, w, ch)
        png = T.encode_batch(img[None], flags, device=DEV)[0]
        check(png == T.encode_batch(img[None], flags, device="cpu")[0],
              f"{what}: card PNG bytes differ from the port's CPU run")
        before = dict(decode_batch.paths)
        sts, outs = T.decode_batch([png], ch, device=DEV)
        check(sts == [0] and np.array_equal(outs[0], img),
              f"{what}: status {sts} or pixels differ")
        path = [k for k, v in decode_batch.paths.items()
                if v > before[k]] or ["stored"]
        if (h, w) == (1, 1) or flags == T.FPNG_FORCE_UNCOMPRESSED:
            want = "stored"
        elif (h, w) in TALL and (ch, flags) != (3, 0):
            want = "pk1"
        else:
            want = "walk8"
        check(path == [want] and is_stored(png) == (want == "stored"),
              f"{what}: decoded on {path}, not {want}")
        taken.append([h, w, ch, flags, want])
    seconds = time.perf_counter() - t
    launches = read()
    check(all(launches[k] > 0 for k in (
        "encode_bits_fused", "crc32_words_masked_raw", "demote_mask",
        "walk_fix8", "walk_fix", "finalize_records8", "finalize_records",
        "scatter_packed16", "expand")),
        f"a kernel never launched on the extreme shapes: {launches}")
    line("extreme_shapes", cases=len(cases), seconds=seconds,
         paths=taken, launches=launches)
    return launches


def abs_err(torch, a, b):
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def p1_times(torch):
    """P1 in all seven modes at the probe's size: step T-1 against the
    plain version, CUDA-event and profiler times, the host's enqueue time
    of one call, bounds, and the library calls doing the same products.
    It calls only functions whose contracts every checkout since P1 was
    ported shares (depparts, depparts_plain, inputs)."""
    from fpng_tpu_torch.tools import prof_depparts as P1

    cu, big, ohc0 = P1.inputs(device=DEV)
    Bn, Tn, R, _ = cu.shape
    wps = R // 32
    # every step's product: 8 rows of big against the 4096 x 128 one-hot
    ops = 2 * 8 * P1.GROUP * 128 * Bn * Tn * wps
    # bytes each mode must read once - cu (the slot columns of every
    # step), big's rows 0..7, ohc0 - and the (B, 8, 128) output written
    b_cu, b_big, b_ohc = 4 * cu.numel(), Bn * wps * 8 * P1.GROUP, ohc0.numel()
    b_out = 4 * Bn * 8 * 128
    full_bound = bound(b_cu + b_big + b_out, ops, TC_INT8_OPS_S)
    mode_bound = {
        "full": full_bound, "fulli8cmp": full_bound,
        "fullbf16": bound(b_cu + b_big + b_out, ops, TC_BF16_OPS_S),
        "ohc": bound(b_cu + b_out, 0),
        "dot": bound(b_big + b_ohc + b_out, ops, TC_INT8_OPS_S),
        "dotbf16": bound(b_big + b_ohc + b_out, ops, TC_BF16_OPS_S),
        "none": bound(Bn * 8 * 128 + b_out, 0)}
    modes = {}
    for mode in P1.ALL_MODES:
        got = P1.depparts(cu, big, ohc0, mode)
        want = P1.depparts_plain(cu, big, ohc0, mode)
        check(torch.equal(got, want), f"P1 {mode} differs from plain")
        bms, by = mode_bound[mode]
        modes[mode] = dict(
            max_abs_err=abs_err(torch, got, want),
            ms=cuda_ms(torch, lambda: P1.depparts(cu, big, ohc0, mode), 10),
            plain_ms=cuda_ms(torch, lambda: P1.depparts_plain(
                cu, big, ohc0, mode), 3),
            **profiler_line(profiled_ms(torch, lambda: P1.depparts(
                cu, big, ohc0, mode))),
            host_ms=host_ms(torch, lambda: P1.depparts(cu, big, ohc0, mode)),
            bound_ms=bms, bound_by=by, library_ms=None)
    # the library yardsticks: every step's products, the sum over walks
    # outside the calls.  dotbf16: one batched bf16 matmul, (B, T*WPS*8,
    # 4096) @ (B, 4096, 128); dot: torch._int_mm on each image's stacked
    # product, (T*WPS*8, 4096) @ (4096, 128), B calls (it refuses m = 8)
    lhs8 = big[:, :, :8][:, None].expand(Bn, Tn, wps, 8, P1.GROUP) \
        .reshape(Bn, Tn * wps * 8, P1.GROUP).contiguous()
    lhs = lhs8.float().bfloat16()
    rhs16 = ohc0.float().bfloat16()
    modes["dotbf16"]["library_ms"] = cuda_ms(
        torch, lambda: torch.matmul(lhs, rhs16), 10)
    rhs8 = [ohc0[b].t().contiguous().t() for b in range(Bn)]  # column-major
    check(torch.equal(torch._int_mm(lhs8[0], rhs8[0])[:8],
                      (big[0, 0, :8].double() @ ohc0[0].double()).int()),
          "torch._int_mm on the stacked product")
    modes["dot"]["library_ms"] = cuda_ms(torch, lambda: [
        torch._int_mm(lhs8[b], rhs8[b]) for b in range(Bn)], 10)
    return modes, [Bn, Tn, wps, big.shape[2]]


def phase_probes(torch):
    """P1 in all seven modes (every one of the T output slots) and P2 in
    both operand types against their plain versions at the probes' own
    sizes, with CUDA-event and profiler times, bounds and, where PyTorch
    calls do the same products, their time."""
    from fpng_tpu_torch.tools import prof_depparts as P1
    from fpng_tpu_torch.tools import prof_int8mxu as P2

    cu, big, ohc0 = P1.inputs(device=DEV)
    for mode in P1.ALL_MODES:  # every step's slot against the plain version
        slots = P1._depparts_slots(cu, big, ohc0, mode)
        bad = [t for t in range(cu.shape[1]) if not torch.equal(
            slots[:, t], P1.depparts_plain(cu[:, t:t + 1], big, ohc0, mode))]
        check(not bad, f"P1 {mode}: slots {bad} differ from plain")
    del cu, big, ohc0, slots
    modes, shape = p1_times(torch)
    lib_note = ("dotbf16: one batched bf16 torch.matmul, (B, T*WPS*8, 4096) "
                "@ (B, 4096, 128); dot: B torch._int_mm calls, (T*WPS*8, "
                "4096) @ (4096, 128) each; the sums over walks outside both")
    res = {"depparts": dict(
        modes["full"], max_abs_err=max(m["max_abs_err"]
                                       for m in modes.values()),
        modes=modes, shape=shape, library_note=lib_note)}

    a, b = P2.inputs(device=DEV)
    K_, reps, Tn2 = a.shape[1], 8, 64
    ops2 = 2 * 128 * K_ * 128 * reps * Tn2
    dts = {}
    for dt, peak in ((torch.int8, TC_INT8_OPS_S),
                     (torch.bfloat16, TC_BF16_OPS_S)):
        got = P2.int8_mxu(a, b, dtype=dt, reps=reps, T=Tn2)
        want = P2.int8_mxu_plain(a, b, dtype=dt, reps=reps)
        check(torch.equal(got, want), f"P2 {dt} differs from plain")
        # the library: the same T * reps products as one stacked product
        # (the casts and the sum over reps outside it)
        if dt == torch.int8:
            stack = torch.cat([(a + r).to(torch.int8) for r in range(reps)])
            rhs = b.to(torch.int8).t().contiguous().t()

            def lib(x=stack.repeat(Tn2, 1), y=rhs):
                return torch._int_mm(x, y)
        else:
            stack = torch.cat([(a + r).float().bfloat16()
                               for r in range(reps)])
            rhs = b.float().bfloat16()

            def lib(x=stack.repeat(Tn2, 1), y=rhs):
                return torch.matmul(x, y)
        try:
            lib_ms = cuda_ms(torch, lib, 5)
        except RuntimeError:
            lib_ms = None
        slots = P2._int8_mxu_slots(a, b, dtype=dt, reps=reps, T=Tn2)
        check(all(torch.equal(x, want) for x in slots),
              f"P2 {dt}: a slot differs from plain")
        del slots
        name = str(dt).replace("torch.", "")
        ms = cuda_ms(torch, lambda: P2.int8_mxu(a, b, dtype=dt, reps=reps,
                                                T=Tn2), 10)
        prof = profiled_ms(torch, lambda: P2.int8_mxu(
            a, b, dtype=dt, reps=reps, T=Tn2))
        # the host's time to enqueue one call (two allocations, two
        # launches through ctypes)
        enqueue_ms = host_ms(torch, lambda: P2.int8_mxu(
            a, b, dtype=dt, reps=reps, T=Tn2))
        clocks = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
        dts[name] = dict(
            max_abs_err=abs_err(torch, got, want), ms=ms,
            plain_ms=cuda_ms(torch, lambda: P2.int8_mxu_plain(
                a, b, dtype=dt, reps=reps), 3),
            library_ms=lib_ms, **profiler_line(prof), host_ms=enqueue_ms,
            sm_clocks_after=clocks,
            # achieved tera-operations/s and the share of this type's dense
            # tensor-core peak, by CUDA events and by the profiler's time
            tops=ops2 / ms / 1e9, peak_share=ops2 / ms / 1e-3 / peak,
            profiler_tops=ops2 / prof[0] / 1e9,
            profiler_peak_share=ops2 / prof[0] / 1e-3 / peak,
            library_tops=ops2 / lib_ms / 1e9 if lib_ms else None)
        dts[name]["bound_ms"], dts[name]["bound_by"] = bound(
            4 * (a.numel() + b.numel()) + 4 * 128 * 128, ops2, peak)
        del lib, stack
    res["int8_mxu"] = dict(
        dts["int8"], max_abs_err=max(d["max_abs_err"] for d in dts.values()),
        dtypes=dts, shape=[128, K_, reps, Tn2])
    return kernel_line(res)


def timed(fn):
    """(fn(), host seconds it took)."""
    t = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t


def phase_stream(torch, T, name, imgs, flags, reset, read, path):
    """encode_batch_stream over 4 batches (the corpus in 4 orders) against
    encode_batch, then decode_batch_stream over the files, one corrupted in
    the middle batch, against decode_batch.  The stream calls run with the
    launch counters set to 0 just before.  Each stream is timed against the
    same batches one call at a time, twice, in the order A B B A."""
    B, H, W_, Cc = imgs.shape
    batches = [imgs[np.random.default_rng(k).permutation(B)]
               for k in range(4)]

    def enc_seq():
        return [T.encode_batch(x, flags, device=DEV) for x in batches]

    def enc_stream():
        return list(T.encode_batch_stream(iter(batches), flags, DEV))

    want, t_es = timed(enc_seq)
    reset()
    got, t_en = timed(enc_stream)
    pngs = [list(p) for p in got]
    pngs[2][0] = pngs[2][0][:40] + b"\xff" + pngs[2][0][41:]

    def dec_seq():
        return [T.decode_batch(p, Cc, device=DEV) for p in pngs]

    def dec_stream():
        return list(T.decode_batch_stream(iter(pngs), Cc, DEV))

    dec, t_dn = timed(dec_stream)
    launches = read()
    check(got == want, f"{name}: encode_batch_stream bytes differ")
    check(all(launches[k] > 0 for k in path),
          f"{name}: a kernel of the path never launched: {launches}")
    ref, t_ds = timed(dec_seq)
    # the second round in the opposite order, so each direction runs A B B A
    t_ds2, t_dn2 = timed(dec_seq)[1], timed(dec_stream)[1]
    t_en2, t_es2 = timed(enc_stream)[1], timed(enc_seq)[1]
    check(len(dec) == 4, f"{name}: decode_batch_stream lost batches")
    for (sts, outs), (wsts, wouts) in zip(dec, ref):
        check(sts == wsts, f"{name}: stream statuses differ")
        check(all((o is None) == (w is None) and
                  (o is None or np.array_equal(o, w))
                  for o, w in zip(outs, wouts)),
              f"{name}: stream pixels differ")
    check(dec[2][0][0] != 0 and dec[2][0][1:] == [0] * (B - 1),
          f"{name}: the corrupted file's status did not stay local")
    check(all(np.array_equal(o, i) for o, i in zip(dec[0][1], batches[0])),
          f"{name}: stream pixels differ from the input")
    mpix = 4 * B * H * W_ / 1e6
    line("stream", name=name, batches=[4, B, H, W_, Cc],
         encode_stream_mpix_s=mpix / min(t_en, t_en2),
         encode_per_batch_mpix_s=mpix / min(t_es, t_es2),
         decode_stream_mpix_s=mpix / min(t_dn, t_dn2),
         decode_per_batch_mpix_s=mpix / min(t_ds, t_ds2),
         encode_s={"stream": [t_en, t_en2], "per_batch": [t_es, t_es2]},
         decode_s={"stream": [t_dn, t_dn2], "per_batch": [t_ds, t_ds2]},
         corrupted_status=dec[2][0][0], launches=launches)
    return launches


def phase_bench(torch, reset, read, path):
    """fpng_tpu_torch.bench's main at full size, launch counters set to 0
    just before: one JSON line, every mode on walk8 or PK=1, and every
    spot check run."""
    from fpng_tpu_torch import bench

    spots = []
    spot = bench._spot_check
    bench._spot_check = lambda *a: spots.append(spot(*a))
    buf = io.StringIO()
    reset()
    try:
        with contextlib.redirect_stdout(buf):
            rc = bench.main()
    finally:
        bench._spot_check = spot
    launches = read()
    out = buf.getvalue().splitlines()
    check(rc == 0 and len(out) == 1, f"bench printed {len(out)} lines")
    res = json.loads(out[0])
    d = res["detail"]
    names = [f"{k}_{m}" for k in ("real3", "real4") for m in ("1pass", "2pass")]
    check(all(d.get(n, {}).get("decode_path") in ("walk8", "pk1")
              for n in names + ["large4k_1pass"]),
          "bench: a mode left the walk paths")
    check(len(spots) == 5, f"bench ran {len(spots)} spot checks, not 5")
    check(all(launches[k] > 0 for k in path),
          f"bench: a kernel of its path never launched: {launches}")
    line("bench", result=res, spot_checks=len(spots), launches=launches)
    return launches


def phase_cli(T, img, reset, read):
    """fpng_tpu_torch.cli's -E (20 trials, dims to 600) and -f on one
    corrupted file (CRC checks off, as a fuzzer runs them), launch
    counters set to 0 just before."""
    from fpng_tpu_torch import cli

    out_dir = os.path.join(HERE, ".build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    png = bytearray(T.encode_batch(img[None], device=DEV)[0])
    check(not is_stored(png), "the -f file is stored")
    idat_len = int.from_bytes(png[50:54], "big")
    png[58 + idat_len // 2] ^= 0x40
    bad = os.path.join(out_dir, "corrupted.png")
    with open(bad, "wb") as f:
        f.write(png)
    buf = io.StringIO()
    os.environ["FPNG_TPU_DISABLE_DECODE_CRC32_CHECKS"] = "1"
    reset()
    try:
        with contextlib.redirect_stdout(buf):
            rc_e = cli.main(["-E", "-n", "20", "-d", "600"])
            rc_f = cli.main(["-f", bad])
    finally:
        del os.environ["FPNG_TPU_DISABLE_DECODE_CRC32_CHECKS"]
    launches = read()
    text = buf.getvalue().splitlines()
    check(rc_e == 0 and "random-dims fuzz: 20 trials OK" in text,
          f"cli -E: {text[-3:]}")
    check(rc_f == 0 and any(t.startswith("status=") for t in text),
          f"cli -f: {text[-3:]}")
    check(launches["encode_bits_fused"] > 0 and
          launches["walk_fix8"] + launches["walk_fix"] > 0,
          f"cli: its kernels never launched: {launches}")
    line("cli", fuzz_E_rc=rc_e, f_rc=rc_f, output=text, launches=launches)
    return launches


def best_s(fn, runs=3):
    """(last result, the least host seconds of `runs` calls of fn())."""
    times = []
    for _ in range(runs):
        out, t = timed(fn)
        times.append(t)
    return out, min(times)


def phase_mesh(torch, T, imgs, pngs, real4, card, reset, read):
    """parallel/mesh.py over make_mesh() (every card) and over [cuda:0,
    cuda:0] at the headline: the sharded encode's bytes against
    encode_batch's, the sharded decode of the dynamic-block files against
    the input, B1, B2 and B3 once a shard (counters set to 0 just before),
    training_step against hist_kernel, full_step_sharded against
    encode_kernel on the whole batch; then the real4 1-pass batch (B7 in
    each shard, the PK=1 walk where a shard's walk8 overflows).  MPix/s
    best of three, beside the single-batch calls' in the same phase."""
    from fpng_tpu_torch.models.decoder import _parse_one, decode_batch
    from fpng_tpu_torch.models.encoder import encode_kernel, hist_kernel
    from fpng_tpu_torch.parallel import mesh as M
    from fpng_tpu_torch.tables import one_pass_state

    B, H, W_, Cc = imgs.shape
    dyn = [j for j, p in enumerate(pngs) if _parse_one(p)[7] is not None]
    _, enc1 = best_s(lambda: T.encode_batch(imgs, device=DEV))
    _, dec1 = best_s(lambda: T.decode_batch([pngs[j] for j in dyn], Cc,
                                            device=DEV))
    want4 = T.encode_batch(real4, device=DEV)
    dyn4 = [j for j, p in enumerate(want4) if _parse_one(p)[7] is not None]
    dev = torch.from_numpy(imgs).to(DEV)
    hist = hist_kernel(dev, num_chans=Cc).sum(0)
    st = one_pass_state(Cc, DEV)

    def col(v):
        return torch.full((B,), v, dtype=torch.int32, device=DEV)

    out = {}
    for name, mesh in (("every_card", M.make_mesh()),
                       ("cuda0_x2", M.make_mesh(["cuda:0", "cuda:0"]))):
        n = mesh.size
        keep = dyn[:len(dyn) - len(dyn) % n]
        files = [pngs[j] for j in keep]
        reset()
        got = M.encode_batch_sharded(mesh, imgs, 0)
        dec, ok = M.decode_batch_sharded(mesh, files, H, W_, Cc)
        launches = read()
        paths = dict(decode_batch.paths)
        check(got == pngs, f"mesh {name}: bytes differ from encode_batch")
        check(bool(ok.all()) and np.array_equal(dec, imgs[keep]),
              f"mesh {name}: sharded decode differs from the input")
        check(launches["encode_bits_fused"] == n and
              launches["crc32_words_masked_raw"] == n and
              launches["walk_fix8"] == n,
              f"mesh {name}: B1, B2, B3 not once a shard: {launches}")
        check(all(launches[k] > 0 for k in ("finalize_records8",
                                            "scatter_packed16", "expand")),
              f"mesh {name}: a decode kernel never launched: {launches}")
        check(paths == {"walk8": n, "pk1": 0, "chunked": 0},
              f"mesh {name}: decode paths {paths}")
        _, enc_s = best_s(lambda: M.encode_batch_sharded(mesh, imgs, 0))
        _, dec_s = best_s(lambda: M.decode_batch_sharded(mesh, files, H, W_,
                                                         Cc))
        check(torch.equal(M.training_step(mesh, imgs, Cc), hist),
              f"mesh {name}: training_step differs from hist_kernel")
        words, bits, adler, ghist = M.full_step_sharded(mesh, imgs, Cc)
        ref = encode_kernel(dev, st.codes.expand(B, -1),
                            st.sizes.expand(B, -1), col(len(st.prefix) * 8),
                            col(st.acc), col(st.nacc), num_chans=Cc,
                            cost_check=False, want_hist=False,
                            num_words=words.shape[1])
        check(torch.equal(words, ref[0]) and torch.equal(bits, ref[1]) and
              torch.equal(adler, ref[3]) and torch.equal(ghist, hist),
              f"mesh {name}: full_step_sharded differs from encode_kernel")
        keep4 = dyn4[:len(dyn4) - len(dyn4) % n]
        reset()
        got4 = M.encode_batch_sharded(mesh, real4, 0)
        dec4, ok4 = M.decode_batch_sharded(
            mesh, [want4[j] for j in keep4], *real4.shape[1:])
        l4 = read()
        p4 = dict(decode_batch.paths)
        check(got4 == want4, f"mesh {name}: real4 bytes differ")
        check(bool(ok4.all()) and np.array_equal(dec4, real4[keep4]),
              f"mesh {name}: real4 sharded decode differs from the input")
        check(l4["demote_mask"] == n and l4["walk_fix8"] == n and
              p4["pk1"] > 0 and l4["walk_fix"] == p4["pk1"] and
              l4["finalize_records"] == p4["pk1"],
              f"mesh {name}: real4 1-pass did not take B7 and PK=1: {l4}, "
              f"{p4}")
        out[name] = dict(
            devices=[str(d) for d in mesh.devices], batch=[B, H, W_, Cc],
            decoded=len(keep), encode_mpix_s=B * H * W_ / 1e6 / enc_s,
            decode_mpix_s=len(keep) * H * W_ / 1e6 / dec_s, encode_s=enc_s,
            decode_s=dec_s, launches=launches, real4_1pass=dict(
                decoded=len(keep4), paths=p4, launches=l4))
    line("mesh", card=card, meshes=out,
         single_batch=dict(encode_mpix_s=B * H * W_ / 1e6 / enc1,
                           decode_mpix_s=len(dyn) * H * W_ / 1e6 / dec1,
                           encode_s=enc1, decode_s=dec1, decoded=len(dyn)))
    return out


def phase_multihost():
    """tools/dryrun_multihost on the card: one rank over NCCL, in its own
    process, which must print its OK line."""
    cmd = [sys.executable, "-m", "fpng_tpu_torch.tools.dryrun_multihost",
           "--device", "cuda"]
    r, secs = timed(lambda: subprocess.run(
        cmd, cwd=HERE, capture_output=True, text=True, timeout=300))
    out = r.stdout.strip().splitlines()
    check(r.returncode == 0 and "MULTIHOST DRYRUN: OK" in out,
          f"multihost dry run (rc {r.returncode}): {out[-5:]} "
          f"{r.stderr[-1500:]}")
    line("multihost", seconds=secs, output=out)


def phase_harness(card, reset, read):
    """The ported tools on the card, launch counters set to 0 before each:
    verify_drive at 4 tiles, bench_mesh on one card at the headline,
    prof_walk8 at the headline and bench_large at B = 2.  Each one's
    output goes into its line; a failure fails the run."""
    from fpng_tpu_torch.tools import (bench_large, bench_mesh, prof_walk8,
                                      verify_drive)

    runs = (
        ("verify_drive", lambda: verify_drive.main(["--tiles", "4"])),
        ("bench_mesh", lambda: bench_mesh.main(["1", "256", "128"])),
        ("prof_walk8", lambda: prof_walk8.main(["256", "128"])),
        ("bench_large", lambda: bench_large.main(["2"])))
    for name, fn in runs:
        buf = io.StringIO()
        reset()
        with contextlib.redirect_stdout(buf):
            rc, secs = timed(fn)
        launches = read()
        text = buf.getvalue().splitlines()
        check(rc == 0, f"{name} failed: {text[-5:]}")
        check(launches["encode_bits_fused"] > 0 and
              launches["walk_fix8"] > 0,
              f"{name}: its kernels never launched: {launches}")
        result = json.loads(text[-1]) if name == "bench_mesh" else text
        line("harness", tool=name, card=card, seconds=secs, result=result,
             launches=launches)


def main():
    sys.path.insert(0, HERE)
    import torch

    # --- 1. environment --------------------------------------------------
    check(torch.cuda.is_available(), "no CUDA device")
    check(os.path.isdir(os.path.join(HERE, "fpng_tpu_torch")),
          "run from a checkout of the repository")
    from fpng_tpu_torch import bench, kernels

    nvcc = subprocess.run([kernels.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    card = bench.card_line(DEV)
    line("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), card=card,
         nvcc=(nvcc.stdout.strip().splitlines() or ["?"])[-1])

    import fpng_tpu_torch as T
    from fpng_tpu_torch import golden
    from fpng_tpu_torch.models.decoder import decode_batch
    from fpng_tpu_torch.ops.bitpack import deposit_bits, scatter_packed16
    from fpng_tpu_torch.models import decoder as TD
    from fpng_tpu_torch.ops.assemble import idat_crc_words
    from fpng_tpu_torch.ops.encfuse import demote_mask, encode_bits_fused
    from fpng_tpu_torch.ops.expand import expand
    from fpng_tpu_torch.ops.specdec_tpu import finalize_records, walk_fix
    from fpng_tpu_torch.ops.walk8 import finalize_records8, walk_fix8
    from fpng_tpu_torch.tools import prof_depparts as P1
    from fpng_tpu_torch.tools import prof_int8mxu as P2

    counters = {"encode_bits_fused": encode_bits_fused,
                "crc32_words_masked_raw": idat_crc_words,
                "deposit_bits": deposit_bits,
                "walk_fix8": walk_fix8,
                "finalize_records8": finalize_records8,
                "scatter_packed16": scatter_packed16,
                "expand": expand,
                "demote_mask": demote_mask,
                "walk_fix": walk_fix,
                "finalize_records": finalize_records,
                "depparts": P1.depparts,
                "int8_mxu": P2.int8_mxu}
    walk8_path = ("encode_bits_fused", "crc32_words_masked_raw", "walk_fix8",
                  "finalize_records8", "scatter_packed16", "expand")
    pk1_path = ("walk_fix", "finalize_records", "scatter_packed16", "expand")
    chunked_path = ("encode_bits_fused", "crc32_words_masked_raw",
                    "deposit_bits")

    def reset():
        for f in counters.values():
            f.launches = 0
        walk_fix8.passes = walk_fix.passes = 0
        decode_batch.device_images = decode_batch.host_handoffs = 0
        decode_batch.walk8_overflows = decode_batch.sub_batches = 0
        decode_batch.paths = {"walk8": 0, "pk1": 0, "chunked": 0}

    def read():
        return {k: f.launches for k, f in counters.items()}

    # --- 2. build ----------------------------------------------------------
    cached = os.path.exists(kernels.library_path())
    t0 = time.perf_counter()
    so = kernels.build()
    kernels.lib()
    line("build", seconds=time.perf_counter() - t0, cached=cached,
         library=os.path.relpath(so, HERE))
    if sys.argv[1:] == ["--expand"]:
        line("expand", card=card, **expand_times(torch, T, bench))
        return
    if sys.argv[1:] == ["--p1"]:
        modes, shape = p1_times(torch)
        line("p1", card=card, shape=shape, modes=modes)
        return
    if sys.argv[1:] == ["--enc"]:
        line("enc", card=card, **enc_times(torch, bench))
        return
    if sys.argv[1:] == ["--globe"]:
        phase_globe(torch, T, reset, read)
        return

    # --- 3. kernels against their plain versions ------------------------------
    imgs = bench.make_corpus("real3")
    B, H, W, Cc = imgs.shape
    kres = phase_kernels(torch, imgs)
    mode_imgs = {3: imgs, 4: bench.make_corpus("real4")}
    kres.update(phase_demote(torch, mode_imgs[4]))
    kres.update(phase_pk1(torch, T, mode_imgs[3]))
    phase_walk8_overflow(torch, T, mode_imgs[4])

    # --- 4. main path at the benchmark's headline size: walk8 decode ---------
    reset()
    pngs = T.encode_batch(imgs, device=DEV)
    sts, outs = T.decode_batch(pngs, Cc, device=DEV)
    launches = read()
    check(all(launches[k] > 0 for k in walk8_path),
          f"a kernel of the walk8 path never launched: {launches}")
    check(launches["walk_fix8"] == 1, "B3 launched more than once a walk")
    check(launches["crc32_words_masked_raw"] == 1 and
          launches["expand"] == 1 and launches["encode_bits_fused"] == 1,
          "B1, B2 or B6 not one launch a call")
    check(not any(launches[k] for k in ("demote_mask", "walk_fix",
                                        "finalize_records", "deposit_bits")),
          f"a kernel off the headline path launched: {launches}")
    check(sts == [0] * B, "decode statuses")
    check(all(np.array_equal(o, i) for o, i in zip(outs, imgs)),
          "decoded pixels differ from the input")
    check(decode_batch.paths == {"walk8": 1, "pk1": 0, "chunked": 0},
          f"headline decode paths {decode_batch.paths}")
    check(decode_batch.host_handoffs == 0 and
          decode_batch.walk8_overflows == 0, "headline hand-offs")
    main_dev = decode_batch.device_images
    check(main_dev > 0, "no image decoded on the device")
    for png, img in zip(pngs, imgs):
        check(zlib_check(png, img), "zlib reconstruction")
    seen = {}
    for png, img in zip(pngs, imgs):
        if png not in seen:
            st, out, *_ = golden.decode_memory(png, Cc)
            seen[png] = (st, out)
        st, out = seen[png]
        check(st == 0 and np.array_equal(out, img), "golden decode")
    check(T.encode_batch(imgs[:8], device="cpu") == pngs[:8],
          "card PNG bytes differ from the port's CPU run")
    check(T.decode_batch(pngs[:8], Cc, device="cpu")[1][3].tobytes() ==
          outs[3].tobytes(), "card pixels differ from the port's CPU run")
    one = T.fpng_encode_image_to_memory(imgs[3], W, H, Cc,
                                         device=DEV)
    check(one == pngs[3], "fpng_encode_image_to_memory")
    st, out, w_, h_, ch = T.fpng_decode_memory(one, 4, device=DEV)
    check(st == 0 and (w_, h_, ch) == (W, H, Cc) and
          np.array_equal(out[..., :3], imgs[3]) and (out[..., 3] == 255).all(),
          "fpng_decode_memory")
    enc_s, dec_s, passes = [], [], []
    for _ in range(3):
        t = time.perf_counter()
        p2 = T.encode_batch(imgs, device=DEV)
        enc_s.append(time.perf_counter() - t)
        n0 = walk_fix8.passes
        t = time.perf_counter()
        s2, _ = T.decode_batch(p2, Cc, device=DEV)
        dec_s.append(time.perf_counter() - t)
        passes.append(walk_fix8.passes - n0)
        check(p2 == pngs and s2 == sts, "steady-state runs differ")
    span_runs = decode_spans(torch, T, pngs, Cc)
    stages = {k: float(np.median([r[k] for r in span_runs]))
              for k in span_runs[0]}
    wall, busy, idle, top = profile_decode(torch, T, pngs, Cc)
    mpix = B * H * W / 1e6
    line("main_path", batch=[B, H, W, Cc], encode_mpix_s=mpix / min(enc_s),
         decode_mpix_s=mpix / min(dec_s), encode_s=enc_s, decode_s=dec_s,
         decode_path="walk8", walk8_passes=passes,
         stored_fallbacks=sum(map(is_stored, pngs)),
         device_decoded=main_dev, host_handoffs=0, walk8_overflows=0,
         golden_checked=len(seen), bytes=sum(map(len, pngs)),
         launches=launches)
    line("decode_stages", batch=[B, H, W, Cc], median=stages,
         spans_cost_s=stages["wall_s"] - float(np.median(dec_s)),
         runs=span_runs)
    line("decode_profile", batch=[B, H, W, Cc], wall_s=wall,
         device_busy_s=busy, device_idle_share=idle, top_device=top)
    line("encode_profile", batch=[B, H, W, Cc],
         **profile_encode(torch, T, imgs))

    # --- 5. large raster -------------------------------------------------------
    big = bench.make_corpus_4k()
    reset()
    times = {}
    for run in range(2):
        t = time.perf_counter()
        bp = T.encode_batch(big, device=DEV)
        te = time.perf_counter() - t
        n0 = walk_fix8.passes
        t = time.perf_counter()
        bs, bo = T.decode_batch(bp, 3, device=DEV)
        times[run] = (te, time.perf_counter() - t, walk_fix8.passes - n0)
    check(bs == [0, 0] and all(np.array_equal(o, i) for o, i in zip(bo, big)),
          "4K round trip")
    check(all(zlib_check(p, i) for p, i in zip(bp, big)), "4K zlib check")
    check(decode_batch.paths == {"walk8": 2, "pk1": 0, "chunked": 0},
          f"4K decode paths {decode_batch.paths}")
    check(decode_batch.device_images == 4, "4K images not decoded on device")
    b1_checked(torch, b1_inputs(torch, big), "4K")
    _, dargs4, wargs4, nc4 = pack_batch(torch, bp)
    walk4k_ms = cuda_ms(torch, lambda: walk_fix8(*wargs4, n_chunks=nc4), 5)
    H4, W4, C4 = big.shape[1:]
    raster4k = walk8_raster(torch, dargs4, nc4, H4, W4 * C4, C4)
    check_expand(torch, raster4k, big, "the 4K walk8 decode")
    expand4k_ms = cuda_ms(torch, lambda: expand(raster4k, h=H4, w=W4, c=C4),
                          5)
    del raster4k
    mpix = big.shape[0] * big.shape[1] * big.shape[2] / 1e6
    line("large_raster", batch=list(big.shape), encode_s=times[1][0],
         decode_s=times[1][1], encode_mpix_s=mpix / times[1][0],
         decode_mpix_s=mpix / times[1][1], first_run_s=list(times[0][:2]),
         decode_path="walk8", walk8_passes=times[1][2],
         walk_fix8_ms=walk4k_ms, walk_fix8_lanes=[len(bp), nc4],
         expand_ms=expand4k_ms, expand_bound_ms=bound(3 * big.size, 0)[0],
         stored_fallbacks=sum(map(is_stored, bp)),
         host_handoffs=decode_batch.host_handoffs,
         bytes=[len(p) for p in bp])

    # --- modes: 24 bpp 2-pass, 32 bpp 1-pass and 2-pass at full size --------
    mode_launches = {}
    for name, c, two_pass in MODES:
        mimgs = mode_imgs[c]
        flags = T.FPNG_ENCODE_SLOWER if two_pass else 0
        reset()
        mp = T.encode_batch(mimgs, flags, device=DEV)
        ms, mo = T.decode_batch(mp, c, device=DEV)
        ml = mode_launches[name] = read()
        walk_passes = {"walk8": walk_fix8.passes, "pk1": walk_fix.passes}
        paths = dict(decode_batch.paths)
        ovf, hand = decode_batch.walk8_overflows, decode_batch.host_handoffs
        check(ms == [0] * len(mimgs) and all(
            np.array_equal(o, i) for o, i in zip(mo, mimgs)),
            f"{name} round trip")
        check((ml["demote_mask"] > 0) == (c == 4 and not two_pass),
              f"{name}: B7 launches {ml['demote_mask']}")
        check(paths["chunked"] == 0 and hand == 0,
              f"{name} left the walk paths: {paths}, {hand} hand-offs")
        check(paths["pk1"] == ovf and paths["walk8"] + ovf == 1,
              f"{name} paths {paths} against {ovf} walk8 overflows")
        check(ovf == 0 or all(ml[k] > 0 for k in pk1_path),
              f"{name}: a kernel of the PK=1 path never launched: {ml}")
        check(ml["walk_fix8"] == 1 and ml["walk_fix"] == paths["pk1"],
              f"{name}: the walks are not one launch each: {ml}")
        for png, img in zip(mp, mimgs):
            check(zlib_check(png, img), f"{name} zlib reconstruction")
        distinct = {}
        for png, img in zip(mp, mimgs):
            if png not in distinct:
                gs, gi, *_ = golden.decode_memory(png, c)
                check(gs == 0 and np.array_equal(gi, img),
                      f"{name} golden decode")
                distinct[png] = True
        check(T.encode_batch(mimgs[:8], flags, device="cpu") == mp[:8],
              f"{name}: card PNG bytes differ from the port's CPU run")
        cs_, co_ = T.decode_batch(mp[:8], c, device="cpu")
        check(cs_ == ms[:8] and all(np.array_equal(a, b)
                                   for a, b in zip(co_, mo[:8])),
              f"{name}: card pixels differ from the port's CPU run")
        enc_s, dec_s = [], []
        for _ in range(3):
            t = time.perf_counter()
            p2 = T.encode_batch(mimgs, flags, device=DEV)
            enc_s.append(time.perf_counter() - t)
            t = time.perf_counter()
            s2, _ = T.decode_batch(p2, c, device=DEV)
            dec_s.append(time.perf_counter() - t)
            check(p2 == mp and s2 == ms, f"{name} steady-state runs differ")
        span_runs = decode_spans(torch, T, mp, c)
        stages = {k: float(np.median([r[k] for r in span_runs]))
                  for k in span_runs[0]}
        mpix = np.prod(mimgs.shape[:3]) / 1e6
        line("mode", name=name, batch=list(mimgs.shape),
             encode_mpix_s=mpix / min(enc_s), decode_mpix_s=mpix / min(dec_s),
             encode_s=enc_s, decode_s=dec_s,
             decode_path="pk1" if ovf else "walk8", paths=paths,
             walk8_overflows=ovf, host_handoffs=hand, passes=walk_passes,
             stored_fallbacks=sum(map(is_stored, mp)),
             golden_checked=len(distinct), bytes=sum(map(len, mp)),
             launches=ml, stages_median=stages, **walk_split(torch, mp))

    # --- 6. walk8 -> PK=1, FPNG_TPU_WALK8=0, and the chunked tier -----------
    ovf_img = np.random.default_rng(0).integers(0, 2, (200, 256, 3)) \
        .astype(np.uint8)
    ovf_png = golden.encode_image_to_memory(ovf_img, 256, 200, 3,
                                            T.FPNG_ENCODE_SLOWER)
    reset()
    os_, oo = T.decode_batch([ovf_png], 3, device=DEV)
    check(os_ == [0] and np.array_equal(oo[0], ovf_img), "overflow image")
    check(decode_batch.walk8_overflows == 1 and
          decode_batch.paths == {"walk8": 0, "pk1": 1, "chunked": 0} and
          decode_batch.host_handoffs == 0 and walk_fix.launches > 0 and
          finalize_records.launches == 1,
          "overflow image did not go walk8 -> PK=1 on the device")
    small_b = imgs[:32]
    cp = T.encode_batch(small_b, device=DEV)
    os.environ["FPNG_TPU_WALK8"] = "0"
    reset()
    ps, po = T.decode_batch(cp, Cc, device=DEV)
    pk1_launches = read()
    del os.environ["FPNG_TPU_WALK8"]
    check(ps == [0] * len(small_b) and all(
        np.array_equal(o, i) for o, i in zip(po, small_b)),
        "FPNG_TPU_WALK8=0 round trip")
    check(decode_batch.paths == {"walk8": 0, "pk1": 1, "chunked": 0} and
          pk1_launches["walk_fix8"] == 0 and
          all(pk1_launches[k] > 0 for k in pk1_path),
          f"FPNG_TPU_WALK8=0 did not take PK=1: {pk1_launches}")
    # the chunked tier takes rasters past the walk gate (ops/walk8.fits);
    # the gate refuses these as it refuses a raster past 2^27 slots
    walk_gate = TD.fits
    TD.fits = lambda h, bpl: False
    try:
        reset()
        t = time.perf_counter()
        cs, co = T.decode_batch(cp, Cc, device=DEV)
        chunked_s = time.perf_counter() - t
        chunked_launches = read()
        check(decode_batch.paths == {"walk8": 0, "pk1": 0, "chunked": 1},
              f"chunked decode paths {decode_batch.paths}")
        reset()
        os_, oo = T.decode_batch([ovf_png], 3, device=DEV)
        chain = dict(decode_batch.paths, host=decode_batch.host_handoffs)
    finally:
        TD.fits = walk_gate
    check(chunked_launches["deposit_bits"] > 0,
          f"B10 never launched on the chunked decode: {chunked_launches}")
    check(cs == [0] * len(small_b) and all(
        np.array_equal(o, i) for o, i in zip(co, small_b)),
        "chunked round trip")
    check(os_ == [0] and np.array_equal(oo[0], ovf_img) and
          chain == {"walk8": 0, "pk1": 0, "chunked": 1, "host": 1},
          f"overflow image past the gate did not go chunked -> host: {chain}")
    line("chunked", batch=list(small_b.shape), decode_s=chunked_s,
         launches=chunked_launches, pk1_launches=pk1_launches,
         overflow_chain=["walk8", "pk1"],
         past_gate_chain=["chunked", "host"])

    # --- walk_gate_edge, extreme_shapes: the walk gate's edge, dim 1 -------
    phase_walk_gate_edge(torch, T, reset, read)
    shape_launches = phase_extreme_shapes(torch, T, reset, read)

    # --- large_raster_2g: a raster past 2^27 bytes on the chunked decode ----
    phase_large_raster_2g(torch, T, reset, read)

    # --- memory_plan: groups past one walk decode's card memory ------------
    phase_memory_plan(torch, T, reset, read)

    # --- globe: one whole-globe raster on each tier -------------------------
    phase_globe(torch, T, reset, read)

    # --- 7. corrupted streams -----------------------------------------------
    rng = np.random.default_rng(11)
    small = [(rng.normal(120, 30, (24, 31, 3)).clip(0, 255)).astype(np.uint8),
             np.full((20, 20, 3), 7, np.uint8), imgs[0][:40, :50]]
    bad = []
    for img in small:
        png = np.frombuffer(T.encode_batch(img[None], device=DEV)[0], np.uint8)
        for _ in range(40):
            b = png.copy()
            k = int(rng.integers(1, 6))
            pos = rng.integers(0, len(b), k)
            b[pos] ^= rng.integers(1, 256, k).astype(np.uint8)
            bad.append(b.tobytes())
    os.environ["FPNG_TPU_DISABLE_DECODE_CRC32_CHECKS"] = "1"
    reset()
    got_st, got_img = T.decode_batch(bad, 3, device=DEV)
    for data, s, im in zip(bad, got_st, got_img):
        gs, gi, *_ = golden.decode_memory(data, 3)
        check(s == gs, f"corrupted stream status {s} != golden {gs}")
        check(gs != 0 or np.array_equal(im, gi), "corrupted stream pixels")
    del os.environ["FPNG_TPU_DISABLE_DECODE_CRC32_CHECKS"]
    check(decode_batch.device_images > 0, "no corrupted stream reached the "
          "device decode")
    line("corrupted", streams=len(bad), statuses_match_golden=len(bad),
         accepted=sum(s == 0 for s in got_st),
         device_decoded=decode_batch.device_images,
         paths=decode_batch.paths)

    # --- probes: P1 and P2, then each probe's main -----------------------
    kres.update(phase_probes(torch))
    buf = io.StringIO()
    reset()
    with contextlib.redirect_stdout(buf):
        rc = P1.main() + P2.main()
    probe_launches = read()
    check(rc == 0 and probe_launches["depparts"] > 0 and
          probe_launches["int8_mxu"] > 0 and
          sum(probe_launches.values()) == probe_launches["depparts"] +
          probe_launches["int8_mxu"],
          f"the probes' mains did not run their kernels: {probe_launches}")
    line("probes", main_output=buf.getvalue().splitlines(),
         launches=probe_launches)

    # --- stream, bench, cli: the harness path at full size ------------------
    encode_path = ("encode_bits_fused", "crc32_words_masked_raw")
    stream_launches = {
        "real3_1pass": phase_stream(torch, T, "real3_1pass", imgs, 0, reset,
                                    read, walk8_path),
        "real4_2pass": phase_stream(torch, T, "real4_2pass", mode_imgs[4],
                                    T.FPNG_ENCODE_SLOWER, reset, read,
                                    encode_path + pk1_path)}
    bench_launches = phase_bench(torch, reset, read,
                                 walk8_path + pk1_path + ("demote_mask",))
    cli_launches = phase_cli(T, imgs[0], reset, read)

    # --- mesh, multihost, harness: data-parallel runs and the tools ---------
    phase_mesh(torch, T, imgs, pngs, mode_imgs[4], card, reset, read)
    phase_multihost()
    phase_harness(card, reset, read)

    # --- 8. close ------------------------------------------------------------
    check("jax" not in sys.modules, "JAX was imported")
    check(not [m for m in sys.modules
               if m == "fpng_tpu" or m.startswith("fpng_tpu.")],
          "fpng_tpu was imported")
    path_launches = dict(
        launches, deposit_bits=chunked_launches["deposit_bits"],
        demote_mask=mode_launches["real4_1pass"]["demote_mask"],
        walk_fix=mode_launches["real3_2pass"]["walk_fix"],
        finalize_records=mode_launches["real3_2pass"]["finalize_records"],
        depparts=probe_launches["depparts"],
        int8_mxu=probe_launches["int8_mxu"])
    line("launches", walk8_path=launches, chunked_path=chunked_launches,
         pk1_path=pk1_launches, modes=mode_launches, probes=probe_launches,
         extreme_shapes=shape_launches,
         stream=stream_launches, bench=bench_launches, cli=cli_launches)
    print(card, flush=True)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": path_launches[name],
         **{k: kres[name][k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms",
                                       "profiler_ms", "modes", "dtypes",
                                       "library_note")
            if k in kres[name]}}
        for name, src, rep in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
