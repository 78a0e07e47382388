#!/usr/bin/env python3
"""Smoke test of fpng_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA card.  It
builds the port's CUDA kernels from fpng_tpu_torch/csrc, holds each kernel
bit-exact against its plain torch version at the main path's shapes, drives
encode_batch / decode_batch (and the single-image entry points) at the
benchmark's sizes (128 x 256 x 256 x 3 and 2 x 2160 x 3840 x 3), checks
every file with zlib and with fpng_tpu.golden, decodes corrupted streams
against golden's statuses, and shows through the launch counters that the
main path ran every kernel.  One line of numbers per phase; then the card,
the per-kernel JSON line, and last {"ok": true, "device": {...}}.  Any
failed check raises and exits non-zero without the ok line.  It imports no
JAX.
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
KERNELS = [  # name, source, the TPU kernel it replaces
    ("encode_bits_fused", "fpng_tpu_torch/csrc/encfuse.cu",
     "fpng_tpu/ops/encfuse.py:188"),
    ("crc32_words_masked_raw", "fpng_tpu_torch/csrc/crc_words.cu",
     "fpng_tpu/ops/checksum.py:376"),
    ("deposit_bits", "fpng_tpu_torch/csrc/deposit.cu",
     "fpng_tpu/ops/bitpack.py:397"),
]


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


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def corpus(B=128, size=256):
    """bench.py's corpus without example.png: synthetic tiles, repeated."""
    from fpng_tpu.train import synthetic_corpus

    tiles = [np.ascontiguousarray(t[:size, :size])
             for t in synthetic_corpus(3, size=size)]
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
    from fpng_tpu_torch.models.encoder import _budget, _num_words, build_desc
    from fpng_tpu_torch.ops.bitpack import (deposit_bits, from_word32,
                                            scatter_bits)
    from fpng_tpu_torch.ops.checksum import crc_chunks, crc_chunks_plain
    from fpng_tpu_torch.ops.encfuse import (encode_bits_fused,
                                            encode_bits_plain)
    from fpng_tpu_torch.ops.specdec import plan_chunks
    from fpng_tpu_torch.tables import one_pass_state

    dev = torch.device(DEV)
    B, H, W, Cc = imgs.shape
    st = one_pass_state(Cc, dev)
    desc, tbl, *_ = build_desc(
        torch.from_numpy(imgs).to(dev), st.codes.expand(B, -1),
        st.sizes.expand(B, -1),
        torch.full((B,), st.acc, dtype=torch.int32, device=dev),
        torch.full((B,), st.nacc, dtype=torch.int32, device=dev),
        num_chans=Cc, cost_check=False)
    base = torch.full((B,), len(st.prefix) * 8, dtype=torch.int32,
                      device=dev)
    budget = _budget(H, W, Cc)
    nw = _num_words(budget)
    res = {}

    def err(a, b):
        return int((from_word32(a) - from_word32(b)).abs().max())

    # B1 against the XLA-path chain, on every word
    got = encode_bits_fused(desc, tbl, base, nw)
    want = encode_bits_plain(desc, tbl, base, nw)
    for g, w_, what in zip(got, want, ("words", "total_bits", "last_tok")):
        check(torch.equal(g, w_), f"B1 {what} differ from the plain chain")
    res["encode_bits_fused"] = dict(
        max_abs_err=err(got[0], want[0]),
        ms=cuda_ms(torch, lambda: encode_bits_fused(desc, tbl, base, nw), 20),
        plain_ms=cuda_ms(torch, lambda: encode_bits_plain(
            desc, tbl, base, nw), 5),
        shape=[B, desc.shape[1]], num_words=nw)

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
        shape=[B, nw], chunks=K, odd_chunks=bool(K % 2))
    check(K % 2 == 1, "the corpus word buffer has an odd chunk count")

    # B10 on decode-style records at the decode's shape for this corpus:
    # sorted 16-bit slots, distinct literal slots, zero-width gaps
    tb = hi.cpu().numpy() + 4 + 16  # zlib stream + adler, CRC + IEND
    nb = 64
    while nb < int(tb.max()):
        nb *= 2
    _, NC, ST = plan_chunks(nb)
    total_slots = H * (1 + W * Cc)
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
        shape=[B, n], num_words=dep_words)
    for name, r in res.items():
        line("kernel", name=name, **r)
    return res


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
    from fpng_tpu import golden
    from fpng_tpu_torch.models.decoder import decode_batch
    from fpng_tpu_torch.ops.bitpack import deposit_bits
    from fpng_tpu_torch.ops.checksum import crc_chunks
    from fpng_tpu_torch.ops.encfuse import encode_bits_fused

    counters = {"encode_bits_fused": encode_bits_fused,
                "crc32_words_masked_raw": crc_chunks,
                "deposit_bits": deposit_bits}

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

    # --- 4. main path at the benchmark's headline size -----------------------
    for f in counters.values():
        f.launches = 0
    decode_batch.device_images = decode_batch.host_handoffs = 0
    pngs = T.encode_batch(imgs, device=DEV)
    sts, outs = T.decode_batch(pngs, Cc, device=DEV)
    launches = {k: f.launches for k, f in counters.items()}
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the main path never launched: {launches}")
    check(sts == [0] * B, "decode statuses")
    check(all(np.array_equal(o, i) for o, i in zip(outs, imgs)),
          "decoded pixels differ from the input")
    check(decode_batch.device_images > 0, "no image decoded on the device")
    main_dev, main_handoffs = (decode_batch.device_images,
                               decode_batch.host_handoffs)
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
    one = T.fpng_encode_image_to_memory(imgs[3], W, H, Cc,
                                         device=DEV)
    check(one == pngs[3], "fpng_encode_image_to_memory")
    st, out, w_, h_, ch = T.fpng_decode_memory(one, 4, device=DEV)
    check(st == 0 and (w_, h_, ch) == (W, H, Cc) and
          np.array_equal(out[..., :3], imgs[3]) and (out[..., 3] == 255).all(),
          "fpng_decode_memory")
    enc_s, dec_s = [], []
    for _ in range(3):
        t = time.perf_counter()
        p2 = T.encode_batch(imgs, device=DEV)
        enc_s.append(time.perf_counter() - t)
        t = time.perf_counter()
        s2, _ = T.decode_batch(p2, Cc, device=DEV)
        dec_s.append(time.perf_counter() - t)
        check(p2 == pngs and s2 == sts, "steady-state runs differ")
    mpix = B * H * W / 1e6
    line("main_path", batch=[B, H, W, Cc], encode_mpix_s=mpix / min(enc_s),
         decode_mpix_s=mpix / min(dec_s), encode_s=enc_s, decode_s=dec_s,
         stored_fallbacks=sum(map(is_stored, pngs)),
         device_decoded=main_dev, host_handoffs=main_handoffs,
         golden_checked=len(seen), bytes=sum(map(len, pngs)),
         launches=launches)

    # --- 5. large raster -------------------------------------------------------
    big = mosaic_4k(tiles)
    decode_batch.device_images = decode_batch.host_handoffs = 0
    times = {}
    for run in range(2):
        t = time.perf_counter()
        bp = T.encode_batch(big, device=DEV)
        te = time.perf_counter() - t
        t = time.perf_counter()
        bs, bo = T.decode_batch(bp, 3, device=DEV)
        times[run] = (te, time.perf_counter() - t)
    check(bs == [0, 0] and all(np.array_equal(o, i) for o, i in zip(bo, big)),
          "4K round trip")
    check(all(zlib_check(p, i) for p, i in zip(bp, big)), "4K zlib check")
    check(decode_batch.device_images > 0, "no 4K image decoded on device")
    mpix = big.shape[0] * big.shape[1] * big.shape[2] / 1e6
    line("large_raster", batch=list(big.shape), encode_s=times[1][0],
         decode_s=times[1][1], encode_mpix_s=mpix / times[1][0],
         decode_mpix_s=mpix / times[1][1], first_run_s=list(times[0]),
         stored_fallbacks=sum(map(is_stored, bp)),
         host_handoffs=decode_batch.host_handoffs // 2,
         bytes=[len(p) for p in bp])

    # --- 6. corrupted streams -----------------------------------------------
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
    decode_batch.device_images = 0
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
         device_decoded=decode_batch.device_images)

    # --- 7. close ------------------------------------------------------------
    check("jax" not in sys.modules, "JAX was imported")
    line("launches", **launches)
    print(card, flush=True)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name],
         "max_abs_err": kres[name]["max_abs_err"],
         "ms": kres[name]["ms"], "plain_ms": kres[name]["plain_ms"]}
        for name, src, rep in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
