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
     walk8), with CUDA-event times and a bytes/operations bound;
  4. drives encode_batch / decode_batch (and the single-image entry
     points) at the headline size, 128 x 256 x 256 x 3: the decode takes
     the walk8 path, every file is checked with zlib and the port's
     golden, three decodes with the decoder's stage spans on give the
     stage split, and one profiled decode gives the device's idle share;
  5. does the same at 2 x 2160 x 3840 x 3;
  modes: drives 24 bpp 2-pass, 32 bpp 1-pass and 32 bpp 2-pass at
     128 x 256 x 256 x c the same way (rates best of three, zlib on every
     file, golden on the distinct ones, the first 8 against the CPU run);
  6. decodes one stream that overflows walk8 through walk8 -> PK=1, 32
     images with FPNG_TPU_WALK8=0 (PK=1 straight away), and, with the
     walk gate refusing as it does for a raster past 2^27 allocated
     slots, the same 32 images on the chunked decode (B10) and the
     overflow stream through chunked -> host;
  7. decodes corrupted streams against golden's statuses.

The launch counters are set to 0 just before each path and read just
after, to show that the path went through its kernels.  One line of
numbers per phase; then the card, the per-kernel JSON line, and last
{"ok": true, "device": {...}}.  Any failed check raises and exits non-zero
without the ok line.  It imports no JAX and nothing of fpng_tpu.
"""

import json
import os
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
]
MODES = [  # name, channels, 2-pass (bench.py's real3/real4 x 1/2-pass)
    ("real3_2pass", 3, True), ("real4_1pass", 4, False),
    ("real4_2pass", 4, True)]


def check(cond, what):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def line(phase, **nums):
    print(json.dumps({"phase": phase, **nums}), flush=True)


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


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the peak 32-bit rate."""
    tb, to = nbytes / HBM_BYTES_S * 1e3, ops / OPS_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def corpus(B=128, size=256, c=3):
    """bench.py's corpus without example.png: synthetic tiles, repeated."""
    from fpng_tpu_torch.train import synthetic_corpus

    tiles = [np.ascontiguousarray(t[:size, :size])
             for t in synthetic_corpus(c, size=size)]
    return np.stack((tiles * -(-B // len(tiles)))[:B]), tiles


def mosaic_4k(tiles, B=2):
    """bench.py's 4K construction (rng seed 7) over the synthetic tiles."""
    H, W = 2160, 3840
    rng = np.random.default_rng(7)
    out = []
    for _ in range(B):
        rows = [np.concatenate([tiles[rng.integers(0, len(tiles))]
                                for _ in range(W // 256)], axis=1)
                for _ in range(-(-H // 256))]
        out.append(np.concatenate(rows, axis=0)[:H, :W])
    return np.stack(out)


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
        rec = np.cumsum(rows[:, 1:].astype(np.int64), axis=0).astype(np.uint8)
    else:  # stored fallback: every row filter 0
        check((rows[:, 0] == 0).all(), "filter bytes")
        rec = rows[:, 1:]
    return np.array_equal(rec.reshape(H, W, Cc), img)


def is_stored(png):
    return (png[58 + 2] & 6) == 0


def phase_kernels(torch, imgs):
    """Each kernel against its plain version at the main path's shapes."""
    import fpng_tpu_torch as T
    from fpng_tpu_torch.models.decoder import _parse_one, pack_streams
    from fpng_tpu_torch.models.encoder import _budget, _num_words, build_desc
    from fpng_tpu_torch.ops import walk8 as W
    from fpng_tpu_torch.ops.bitpack import (deposit_bits, from_word32,
                                            scatter_bits, scatter_packed16,
                                            scatter_packed16_plain)
    from fpng_tpu_torch.ops.checksum import crc_chunks, crc_chunks_plain
    from fpng_tpu_torch.ops.encfuse import (encode_bits_fused,
                                            encode_bits_plain)
    from fpng_tpu_torch.ops.expand import expand, expand_plain
    from fpng_tpu_torch.ops.specdec import plan_chunks
    from fpng_tpu_torch.tables import one_pass_state

    dev = torch.device(DEV)
    B, H, W_, Cc = imgs.shape
    st = one_pass_state(Cc, dev)
    desc, tbl, *_ = build_desc(
        torch.from_numpy(imgs).to(dev), st.codes.expand(B, -1),
        st.sizes.expand(B, -1),
        torch.full((B,), st.acc, dtype=torch.int32, device=dev),
        torch.full((B,), st.nacc, dtype=torch.int32, device=dev),
        num_chans=Cc, cost_check=False)
    base = torch.full((B,), len(st.prefix) * 8, dtype=torch.int32,
                      device=dev)
    budget = _budget(H, W_, Cc)
    nw = _num_words(budget)
    res = {}

    def err(a, b):
        return int((from_word32(a) - from_word32(b)).abs().max())

    def masked_err(a, b):
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())

    # B1 against the XLA-path chain, on every word
    got = encode_bits_fused(desc, tbl, base, nw)
    want = encode_bits_plain(desc, tbl, base, nw)
    for g, w_, what in zip(got, want, ("words", "total_bits", "last_tok")):
        check(torch.equal(g, w_), f"B1 {what} differ from the plain chain")
    N = desc.shape[1]
    res["encode_bits_fused"] = dict(
        max_abs_err=err(got[0], want[0]),
        ms=cuda_ms(torch, lambda: encode_bits_fused(desc, tbl, base, nw), 20),
        plain_ms=cuda_ms(torch, lambda: encode_bits_plain(
            desc, tbl, base, nw), 5),
        # desc read, table read, words written; ~20 ops a unit (lookup,
        # scan, shifts, deposit)
        bound=bound(4 * B * N + 4 * tbl.numel() + 4 * B * nw, 20 * B * N),
        shape=[B, N], num_words=nw)

    # B2 on the corpus words, masked to each image's payload
    words, total, _ = got
    lo = torch.full((B,), len(st.prefix), dtype=torch.int64, device=dev)
    hi = (total.to(torch.int64) + 7) >> 3
    g2 = crc_chunks(words, lo, hi)
    w2 = crc_chunks_plain(words, lo, hi)
    check(torch.equal(g2, w2), "B2 chunk registers differ from plain")
    K = nw // 1024
    res["crc32_words_masked_raw"] = dict(
        max_abs_err=int((g2 - w2).abs().max()),
        ms=cuda_ms(torch, lambda: crc_chunks(words, lo, hi), 20),
        plain_ms=cuda_ms(torch, lambda: crc_chunks_plain(words, lo, hi), 5),
        # words read, registers written; ~3 ops a byte (table lookup, xor,
        # shift)
        bound=bound(4 * B * nw + 4 * B * K, 12 * B * nw),
        shape=[B, nw], chunks=K, odd_chunks=bool(K % 2))
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
    offs = (outp * 16).to(torch.int32)
    dep_words = -(-(16 * (total_slots + 1)) // 32) + 1
    g3 = deposit_bits(vals, nbits, offs, dep_words)
    w3 = scatter_bits(vals, nbits, offs, dep_words)
    check(torch.equal(g3, w3), "B10 words differ from scatter_bits")
    res["deposit_bits"] = dict(
        max_abs_err=err(g3, w3),
        ms=cuda_ms(torch, lambda: deposit_bits(vals, nbits, offs, dep_words),
                   20),
        plain_ms=cuda_ms(torch, lambda: scatter_bits(
            vals, nbits, offs, dep_words), 5),
        # vals + offsets read, words written; ~10 ops a unit
        bound=bound(8 * B * n + 4 * B * dep_words, 10 * B * n),
        shape=[B, n], num_words=dep_words)

    # B3-B6 on the walk8 decode of the corpus's own dynamic-block streams
    pngs = T.encode_batch(imgs, device=DEV)
    metas = [m for m in map(_parse_one, pngs) if m[7] is not None]
    stream, luts, p0, zl = pack_streams(metas)
    Bd = len(metas)
    st_d = torch.from_numpy(stream).to(dev)
    lut32 = torch.from_numpy(luts.astype(np.int32)).to(dev)
    p0_d = torch.from_numpy(p0).to(dev)
    zl_d = torch.from_numpy(zl).to(dev)
    nc = W.n_chunks(int(zl.max()))
    words8 = W.stream_words(st_d)
    p0_32, zl8_32 = p0_d.to(torch.int32), (zl_d * 8).to(torch.int32)

    def walk():
        return W.walk_fix8(words8, lut32, p0_32, zl8_32, n_chunks=nc)

    def walk_plain():
        return W.walk_fix8_plain(words8, lut32, p0_32, zl8_32, n_chunks=nc)

    g4, w4 = walk(), walk_plain()
    check(g4[6] == w4[6], f"B3 passes {g4[6]} != plain {w4[6]}")
    for a, b, what in zip(g4[:3], w4[:3], ("e_fin", "nst", "ovf")):
        check(torch.equal(a, b), f"B3 {what} differs from plain")
    rows = torch.arange(g4[3].shape[1], device=dev)[None, :, None] < \
        w4[1][:, None]
    e3 = 0
    for a, b, what in zip(g4[3:6], w4[3:6], ("posr", "raw0", "raw1")):
        a, b = torch.where(rows, a, 0), torch.where(rows, b, 0)
        check(torch.equal(a, b), f"B3 {what} records differ from plain")
        e3 = max(e3, masked_err(a, b))
    check(not bool(g4[2].any()), "the headline corpus overflows walk8")
    steps_sum = int(g4[1].sum())
    res["walk_fix8"] = dict(
        max_abs_err=max(e3, masked_err(g4[0], w4[0])),
        ms=cuda_ms(torch, walk, 5), plain_ms=cuda_ms(torch, walk_plain, 1),
        # stream words and LUTs read, 12 record bytes a recorded step and
        # 16 bytes a lane written; ~30 ops a step
        bound=bound(4 * words8.numel() + 4 * lut32.numel() +
                    12 * steps_sum + 16 * Bd * nc, 30 * steps_sum),
        shape=[Bd, nc], step_rows=int(g4[3].shape[1]),
        passes=g4[6], recorded_steps=steps_sum)

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
        # 12 bytes a recorded row read, 8 bytes an output row written, 12
        # bytes a lane read, 12 a check triple written; ~60 ops a recorded
        # row, ~4 an output row
        bound=bound(12 * read_rows + 8 * out_rows + 12 * Bd * nc + 12 * Bd,
                    60 * read_rows + 4 * out_rows),
        shape=[Bd, k8, nc], read_rows=read_rows)

    n_slots = H * W_ * Cc
    meta, metb = (a.reshape(Bd, -1) for a in g5[:2])
    g6 = scatter_packed16(meta, metb, n_slots)
    w6 = scatter_packed16_plain(meta, metb, n_slots)
    check(torch.equal(g6, w6), "B5 raster differs from plain")
    lit_records = int((metb != 0).sum())
    res["scatter_packed16"] = dict(
        max_abs_err=masked_err(g6, w6),
        ms=cuda_ms(torch, lambda: scatter_packed16(meta, metb, n_slots), 20),
        plain_ms=cuda_ms(torch, lambda: scatter_packed16_plain(
            meta, metb, n_slots), 5),
        # the value word of every record read, the slot word of each record
        # that carries a literal, the raster written once; ~8 ops a record
        bound=bound(4 * meta.numel() + 4 * lit_records + 2 * Bd * n_slots,
                    8 * meta.numel()),
        shape=[Bd, meta.shape[1]], n_slots=n_slots, lit_records=lit_records)

    g7 = expand(g6, h=H, w=W_, c=Cc)
    w7 = expand_plain(g6, h=H, w=W_, c=Cc)
    check(torch.equal(g7, w7), "B6 pixels differ from plain")
    idx = [i for i, p in enumerate(pngs) if not is_stored(p)]
    check(np.array_equal(g7.cpu().numpy(), imgs[idx]),
          "B3-B6 chain pixels differ from the corpus")
    res["expand"] = dict(
        max_abs_err=masked_err(g7, w7),
        ms=cuda_ms(torch, lambda: expand(g6, h=H, w=W_, c=Cc), 20),
        plain_ms=cuda_ms(torch, lambda: expand_plain(g6, h=H, w=W_, c=Cc), 5),
        # slots read, bytes written and re-read/re-written by the defilter
        # count once; ~8 ops a slot
        bound=bound(3 * Bd * n_slots, 8 * Bd * n_slots),
        shape=[Bd, H, W_, Cc])
    return kernel_line(res)


def kernel_line(res):
    for name, r in res.items():
        r["bound_ms"], r["bound_by"] = r.pop("bound")
        r["library_ms"] = None  # no single PyTorch call computes these
        line("kernel", name=name, **r)
    return res


def phase_demote(torch, imgs):
    """B7 against its plain version on the cost-check inputs of a 32 bpp
    1-pass batch (the 1-pass tables)."""
    from fpng_tpu_torch.models.encoder import tokens
    from fpng_tpu_torch.ops.encfuse import demote_mask, demote_mask_plain
    from fpng_tpu_torch.tables import one_pass_state

    B, H, W_, Cc = imgs.shape
    st = one_pass_state(Cc, DEV)
    deltas, _, mstart, mlen, _, ls, le = tokens(
        torch.from_numpy(imgs).to(DEV), Cc)
    args = (deltas, ls, le, mstart & (mlen == 1), st.tbl.expand(B, 8, 128)
            .contiguous())
    got, want = demote_mask(*args), demote_mask_plain(*args)
    check(torch.equal(got, want), "B7 mask differs from plain")
    n_px, n_cand = B * H * W_, int(args[3].sum())
    check(n_cand > 0 and bool(got.any()), "the corpus has no demotion")
    return kernel_line({"demote_mask": dict(
        max_abs_err=int((got.to(torch.int32) - want.to(torch.int32))
                        .abs().max()),
        ms=cuda_ms(torch, lambda: demote_mask(*args), 20),
        plain_ms=cuda_ms(torch, lambda: demote_mask_plain(*args), 5),
        # cand read and the mask written, a byte a pixel; 4 delta bytes,
        # len_sym and len_extra read per candidate; the 288 sizes per
        # image; ~12 ops a candidate, 2 a pixel
        bound=bound(2 * n_px + 12 * n_cand + 4 * 288 * B,
                    12 * n_cand + 2 * n_px),
        shape=[B, H, W_, Cc], candidates=n_cand,
        demoted=int(got.sum()))})


def phase_pk1(torch, T, imgs):
    """B8 and B9 against their plain versions on the decode of a 2-pass
    batch whose streams overflow walk8's 96 step rows."""
    from fpng_tpu_torch.models.decoder import _parse_one, pack_streams
    from fpng_tpu_torch.ops import specdec_tpu as PK
    from fpng_tpu_torch.ops import walk8 as W
    from fpng_tpu_torch.ops.bitpack import scatter_packed16
    from fpng_tpu_torch.ops.expand import expand

    B, H, W_, Cc = imgs.shape
    pngs = T.encode_batch(imgs, T.FPNG_ENCODE_SLOWER, device=DEV)
    metas = [m for m in map(_parse_one, pngs) if m[7] is not None]
    stream, luts, p0, zl = pack_streams(metas)
    Bd = len(metas)
    st_d = torch.from_numpy(stream).to(DEV)
    lut32 = torch.from_numpy(luts.astype(np.int32)).to(DEV)
    p0_d = torch.from_numpy(p0).to(DEV)
    zl_d = torch.from_numpy(zl).to(DEV)
    nc = W.n_chunks(int(zl.max()))
    ovf = W.decode_walk8(st_d, lut32, p0_d, zl_d, n_chunks=nc)[4]
    n_ovf = int(ovf.sum())
    check(n_ovf > 0, "the 2-pass corpus does not overflow walk8")
    words = W.stream_words(st_d)
    p0_32, zl8_32 = p0_d.to(torch.int32), (zl_d * 8).to(torch.int32)

    def walk():
        return PK.walk_fix(words, lut32, p0_32, zl8_32, n_chunks=nc)

    def walk_plain():
        return PK.walk_fix_plain(words, lut32, p0_32, zl8_32, n_chunks=nc)

    g, w = walk(), walk_plain()
    check(g[6] == w[6], f"B8 passes {g[6]} != plain {w[6]}")
    for a, b, what in zip(g[:3], w[:3], ("e_fin", "nst", "ovf")):
        check(torch.equal(a, b), f"B8 {what} differs from plain")
    rows = torch.arange(PK.ST8, device=DEV)[None, :, None] < w[1][:, None]
    err = int((g[0].to(torch.int64) - w[0].to(torch.int64)).abs().max())
    for a, b, what in zip(g[3:6], w[3:6], ("posr", "raw0", "raw1")):
        a, b = torch.where(rows, a, 0), torch.where(rows, b, 0)
        check(torch.equal(a, b), f"B8 {what} records differ from plain")
        err = max(err, int((a.to(torch.int64) - b.to(torch.int64))
                           .abs().max()))
    steps_sum = int(g[1].sum())
    res = {"walk_fix": dict(
        max_abs_err=err, ms=cuda_ms(torch, walk, 3),
        plain_ms=cuda_ms(torch, walk_plain, 1),
        # as walk_fix8: stream words and LUTs read, 12 record bytes a
        # recorded step and 16 bytes a lane written; ~30 ops a step
        bound=bound(4 * words.numel() + 4 * lut32.numel() +
                    12 * steps_sum + 16 * Bd * nc, 30 * steps_sum),
        shape=[Bd, nc], step_rows=PK.ST8, passes=g[6],
        recorded_steps=steps_sum, max_lane_steps=int(g[1].max()),
        walk8_overflow_images=n_ovf)}

    records, e_fin, out0, steps, _, _ = W.walk_offsets(
        PK.walk_fix, st_d, lut32, p0_d, zl_d, n_chunks=nc)
    k8 = W.trim_steps(int(steps), PK.ST8)
    check(k8 > 8 * W.MAXIT, f"PK=1 trim {k8} within walk8's rows")
    kw = dict(k8=k8, h=H, bpl=W_ * Cc, c=Cc)
    fin_args = (*records, e_fin, out0)
    g5 = PK.finalize_records(*fin_args, **kw)
    w5 = PK.finalize_records_plain(*fin_args, **kw)
    for a, b, what in zip(g5, w5, ("meta", "metb", "chk")):
        check(torch.equal(a, b), f"B9 {what} differs from plain")
    read_rows = int(torch.clamp(records[3], max=k8).sum())
    out_rows = Bd * k8 * nc
    res["finalize_records"] = dict(
        max_abs_err=max(int((a.to(torch.int64) - b.to(torch.int64))
                            .abs().max()) for a, b in zip(g5, w5)),
        ms=cuda_ms(torch, lambda: PK.finalize_records(*fin_args, **kw), 10),
        plain_ms=cuda_ms(torch, lambda: PK.finalize_records_plain(
            *fin_args, **kw), 2),
        # as finalize_records8: 12 bytes a recorded row read, 8 an output
        # row written, 12 a lane read, 12 a check triple written
        bound=bound(12 * read_rows + 8 * out_rows + 12 * Bd * nc + 12 * Bd,
                    60 * read_rows + 4 * out_rows),
        shape=[Bd, k8, nc], read_rows=read_rows)
    raster = scatter_packed16(g5[0].reshape(Bd, -1), g5[1].reshape(Bd, -1),
                              H * W_ * Cc)
    idx = [i for i, p in enumerate(pngs) if not is_stored(p)]
    check(np.array_equal(expand(raster, h=H, w=W_, c=Cc).cpu().numpy(),
                         imgs[idx]), "B8-B9 chain pixels differ from the "
          "corpus")
    return kernel_line(res)


def decode_spans(torch, T, pngs, Cc, runs=3):
    """decode_batch runs with the decoder's stage spans on
    (models/decoder.py:_span, a synchronise at each end of a stage): per
    run its wall time, each stage, and rest = wall - the stages (Python
    between the spans), all from that one run."""
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


def profile_decode(torch, T, pngs, Cc):
    """One decode under torch.profiler: (wall s, device busy s, device
    idle share, the five device kernels with the most time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        T.decode_batch(pngs, Cc, device=DEV)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    spans, per_name = [], {}
    for e in prof.events():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        s, t_end = e.time_range.start, e.time_range.end
        spans.append((s, t_end))
        per_name[e.name] = per_name.get(e.name, 0.0) + (t_end - s) / 1e6
    if not spans:
        return wall, None, None, []
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
    return wall, busy, 1 - busy / wall, [[k[:60], v] for k, v in top]


def walk_split(torch, pngs):
    """Host-clock seconds of the two device decodes of one packed batch:
    the walk8 attempt (decode_kernel8; None when it overflows) and the
    PK=1 decode, each ending in a synchronise."""
    from fpng_tpu_torch.models.decoder import _parse_one, pack_streams
    from fpng_tpu_torch.ops.specdec_tpu import decode_kernel_pk1
    from fpng_tpu_torch.ops.walk8 import decode_kernel8

    metas = [m for m in map(_parse_one, pngs) if m[7] is not None]
    _, w, h, c, *_ = metas[0]
    stream, luts, p0, zl = pack_streams(metas)
    args = [torch.from_numpy(a.astype(t)).to(DEV) for a, t in zip(
        (stream, luts, p0, zl), (np.uint8, np.int64, np.int64, np.int64))]
    out = {}
    for name, fn in (("walk8_s", decode_kernel8),
                     ("pk1_s", decode_kernel_pk1)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn(*args, h=h, w=w, c=c, zlib_len_max=int(zl.max()))
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t
    return out


def main():
    sys.path.insert(0, HERE)
    import torch

    # --- 1. environment --------------------------------------------------
    check(torch.cuda.is_available(), "no CUDA device")
    check(os.path.isdir(os.path.join(HERE, "fpng_tpu_torch")),
          "run from a checkout of the repository")
    from fpng_tpu_torch import kernels

    nvcc = subprocess.run([kernels.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    card = card_line()
    line("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), card=card,
         nvcc=(nvcc.stdout.strip().splitlines() or ["?"])[-1])

    import fpng_tpu_torch as T
    from fpng_tpu_torch import golden
    from fpng_tpu_torch.models.decoder import decode_batch
    from fpng_tpu_torch.ops.bitpack import deposit_bits, scatter_packed16
    from fpng_tpu_torch.models import decoder as TD
    from fpng_tpu_torch.ops.checksum import crc_chunks
    from fpng_tpu_torch.ops.encfuse import demote_mask, encode_bits_fused
    from fpng_tpu_torch.ops.expand import expand
    from fpng_tpu_torch.ops.specdec_tpu import finalize_records, walk_fix
    from fpng_tpu_torch.ops.walk8 import finalize_records8, walk_fix8

    counters = {"encode_bits_fused": encode_bits_fused,
                "crc32_words_masked_raw": crc_chunks,
                "deposit_bits": deposit_bits,
                "walk_fix8": walk_fix8,
                "finalize_records8": finalize_records8,
                "scatter_packed16": scatter_packed16,
                "expand": expand,
                "demote_mask": demote_mask,
                "walk_fix": walk_fix,
                "finalize_records": finalize_records}
    walk8_path = ("encode_bits_fused", "crc32_words_masked_raw", "walk_fix8",
                  "finalize_records8", "scatter_packed16", "expand")
    pk1_path = ("walk_fix", "finalize_records", "scatter_packed16", "expand")
    chunked_path = ("encode_bits_fused", "crc32_words_masked_raw",
                    "deposit_bits")

    def reset():
        for f in counters.values():
            f.launches = 0
        decode_batch.device_images = decode_batch.host_handoffs = 0
        decode_batch.walk8_overflows = 0
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

    # --- 3. kernels against their plain versions ------------------------------
    imgs, tiles = corpus()
    B, H, W, Cc = imgs.shape
    kres = phase_kernels(torch, imgs)
    mode_imgs = {3: imgs, 4: corpus(c=4)[0]}
    kres.update(phase_demote(torch, mode_imgs[4]))
    kres.update(phase_pk1(torch, T, mode_imgs[3]))

    # --- 4. main path at the benchmark's headline size: walk8 decode ---------
    reset()
    pngs = T.encode_batch(imgs, device=DEV)
    sts, outs = T.decode_batch(pngs, Cc, device=DEV)
    launches = read()
    check(all(launches[k] > 0 for k in walk8_path),
          f"a kernel of the walk8 path never launched: {launches}")
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
        n0 = walk_fix8.launches
        t = time.perf_counter()
        s2, _ = T.decode_batch(p2, Cc, device=DEV)
        dec_s.append(time.perf_counter() - t)
        passes.append(walk_fix8.launches - n0)
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

    # --- 5. large raster -------------------------------------------------------
    big = mosaic_4k(tiles)
    reset()
    times = {}
    for run in range(2):
        t = time.perf_counter()
        bp = T.encode_batch(big, device=DEV)
        te = time.perf_counter() - t
        n0 = walk_fix8.launches
        t = time.perf_counter()
        bs, bo = T.decode_batch(bp, 3, device=DEV)
        times[run] = (te, time.perf_counter() - t, walk_fix8.launches - n0)
    check(bs == [0, 0] and all(np.array_equal(o, i) for o, i in zip(bo, big)),
          "4K round trip")
    check(all(zlib_check(p, i) for p, i in zip(bp, big)), "4K zlib check")
    check(decode_batch.paths == {"walk8": 2, "pk1": 0, "chunked": 0},
          f"4K decode paths {decode_batch.paths}")
    check(decode_batch.device_images == 4, "4K images not decoded on device")
    mpix = big.shape[0] * big.shape[1] * big.shape[2] / 1e6
    line("large_raster", batch=list(big.shape), encode_s=times[1][0],
         decode_s=times[1][1], encode_mpix_s=mpix / times[1][0],
         decode_mpix_s=mpix / times[1][1], first_run_s=list(times[0][:2]),
         decode_path="walk8", walk8_passes=times[1][2],
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
             walk8_overflows=ovf, host_handoffs=hand,
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

    # --- 7. corrupted streams -----------------------------------------------
    rng = np.random.default_rng(11)
    small = [(rng.normal(120, 30, (24, 31, 3)).clip(0, 255)).astype(np.uint8),
             np.full((20, 20, 3), 7, np.uint8), tiles[0][:40, :50]]
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

    # --- 8. close ------------------------------------------------------------
    check("jax" not in sys.modules, "JAX was imported")
    check(not [m for m in sys.modules
               if m == "fpng_tpu" or m.startswith("fpng_tpu.")],
          "fpng_tpu was imported")
    path_launches = dict(
        launches, deposit_bits=chunked_launches["deposit_bits"],
        demote_mask=mode_launches["real4_1pass"]["demote_mask"],
        walk_fix=mode_launches["real3_2pass"]["walk_fix"],
        finalize_records=mode_launches["real3_2pass"]["finalize_records"])
    line("launches", walk8_path=launches, chunked_path=chunked_launches,
         pk1_path=pk1_launches, modes=mode_launches)
    print(card, flush=True)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": path_launches[name],
         **{k: kres[name][k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms")}}
        for name, src, rep in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
