"""Benchmark of fpng_tpu_torch on one CUDA card (counterpart of bench.py).

    python -m fpng_tpu_torch.bench

Prints ONE JSON line with bench.py's keys, its numbers unrounded:
{"metric", "value", "unit", "vs_baseline", "detail"}; detail holds one
entry per {kind}_{mode}, the per-class size gates (size_gate_*), the 4K
point (large4k_1pass) and the card's `nvidia-smi` name and power limit
(card).

Corpora: 128 x 256 x 256 x c tiles of train.synthetic_corpus(c) (40
classes, repeated), bench.py's own fallback when example.png is absent -
the port has no real_corpus: real3 is the 3-channel corpus, real4 the
4-channel one.  The 4K point is 2 x 2160 x 3840 x 3 mosaics of the
3-channel tiles (rng seed 7), bench.py's construction over the synthetic
tiles.  Modes: 1-pass and 2-pass (FPNG_ENCODE_SLOWER).

Methodology, as bench.py's: best of 3 samples, each of K = 4 chained
launches ending in one scalar readback, with pixels already on the card.
Encode = the 2-pass histogram (issued one batch ahead) and host table
build + the device encode; encode_with_assembly = mpix / max(device stage
with the IDAT CRC, host tail), with the tail timed on fresh results and the
readback (d2h_s) reported beside it.  Decode = the dispatch decode_batch
ships (walk8 -> PK=1 -> chunked) after an untimed parse and pack.  Serving
= the streaming API end to end (parse, copies, kernels, assembly), 2 warm
rounds then 6 timed.  Correctness is checked every run: each mode's first
two files round-trip through the public API and through zlib with a
per-row defilter.

vs_baseline compares the headline (real3 1-pass aggregate) with the
reference's single-core figures on its own corpus (BASELINE.md): an
outside yardstick, not the same corpus.

Environment: FPNG_TPU_BENCH_ONLY (e.g. "real3_1pass"; substring match, as
bench.py) runs only the named modes, without size gates or 4K;
FPNG_TPU_BENCH_4K=0 skips the 4K point; FPNG_TPU_PROFILE=<dir> writes a
torch.profiler Chrome trace of the run there.  bench.py's
FPNG_TPU_BUCKET_DENSITY is not read: it sizes the TPU's lane buckets, and
the port's walk sizes its lanes itself.  Its _shard is not ported: the
bench runs on one card until the port has its mesh.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import time
import zlib

import numpy as np
import torch

from .tools.profile_kernels import force1, profiled

BASE = {
    # reference single-core MPix/s (BASELINE.md corpus 1 and corpus 3)
    ("real3", "1pass"): (110.16, 162.01),
    ("real3", "2pass"): (68.32, 165.73),
    ("real4", "1pass"): (93.10, 128.43),
    ("real4", "2pass"): (59.12, 136.46),
}
_HBM_GBPS = 3.35e12  # H100 SXM HBM3 bytes/s (speed-of-light denominator)
K_CHAIN = 4  # chained launches per sample


def make_corpus(kind: str, B: int = 128, size: int = 256) -> np.ndarray:
    from .train import synthetic_corpus

    ch = 3 if kind == "real3" else 4
    tiles = [np.ascontiguousarray(t[:size, :size])
             for t in synthetic_corpus(ch, size=size)]
    return np.stack((tiles * -(-B // len(tiles)))[:B])


def make_corpus_4k(B: int = 2) -> np.ndarray:
    """(B, 2160, 3840, 3) mosaics of the 3-channel 256 x 256 tiles (rng
    seed 7)."""
    from .train import synthetic_corpus

    H, W = 2160, 3840
    tiles = [np.ascontiguousarray(t[:256, :256])
             for t in synthetic_corpus(3, size=256)]
    rng = np.random.default_rng(7)
    out = []
    for _ in range(B):
        rows = [np.concatenate([tiles[rng.integers(0, len(tiles))]
                                for _ in range(W // 256)], axis=1)
                for _ in range(-(-H // 256))]
        out.append(np.concatenate(rows, axis=0)[:H, :W])
    return np.stack(out)


def card_line(device) -> str:
    """`nvidia-smi`'s name and power limit of the card, or "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"bench: {what}")


def _bench_encode(imgs: np.ndarray, flags: int, device):
    """(encode MPix/s, encode-with-assembly MPix/s, stage detail, PNGs)."""
    import fpng_tpu_torch as T
    from .models.encoder import (_budget, _finish_batch_devcrc, _num_words,
                                 _prepare_tables, encode_kernel, hist_kernel,
                                 launch_assemble)
    from .models.transfer import finish_readback, start_readback, to_device

    B, H, W, Cc = imgs.shape
    mpix = B * H * W / 1e6
    budget = _budget(H, W, Cc)
    num_words = _num_words(budget)
    dev = to_device(imgs, device)
    two_pass = bool(flags & T.FPNG_ENCODE_SLOWER)

    def col(a):
        return to_device(np.asarray(a, np.int32), dev.device)

    def run(hist_dev=None):
        if two_pass and hist_dev is None:
            hist_dev = hist_kernel(dev, num_chans=Cc)
        codes, sizes, prefixes, pv, pn, cost_check = _prepare_tables(
            imgs, hist_dev, flags, dev.device)
        out = encode_kernel(dev, codes, sizes,
                            col([len(p) * 8 for p in prefixes]), col(pv),
                            col(pn), num_chans=Cc, cost_check=cost_check,
                            want_hist=False, num_words=num_words)
        return out, prefixes

    def chained(step):
        """Best of 3 samples of K_CHAIN launches, the 2-pass histogram of
        the next launch issued before this one's tables are built."""
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            h_next = hist_kernel(dev, num_chans=Cc) if two_pass else None
            for k in range(K_CHAIN):
                h_cur = h_next
                h_next = (hist_kernel(dev, num_chans=Cc)
                          if two_pass and k + 1 < K_CHAIN else None)
                last = step(h_cur)
            force1(last)
            times.append((time.perf_counter() - t0) / K_CHAIN)
        return min(times)

    force1(run()[0][1])  # warm
    enc_s = chained(lambda h: run(h)[0][1])

    def run_e2e(h_cur):
        (words, total_bits, last_tok, adler, _), prefixes = run(h_cur)
        crc = launch_assemble(words, total_bits, adler, prefixes)
        return (words, crc, total_bits, last_tok, adler), prefixes

    force1(run_e2e(None)[0][1])  # warm
    dev_s = chained(lambda h: run_e2e(h)[0][1])
    # the readback of fresh results, then the host tail on them
    fresh, prefixes = run_e2e(None)
    force1(fresh[1])
    t0 = time.perf_counter()
    host_new = finish_readback(start_readback(fresh))
    d2h_s = time.perf_counter() - t0
    ht = []
    for _ in range(3):
        t0 = time.perf_counter()
        pngs_e2e = _finish_batch_devcrc(imgs, *host_new, prefixes, budget)
        ht.append(time.perf_counter() - t0)
    host_s = min(ht)
    pngs = T.encode_batch(imgs, flags, device)  # container path (untimed)
    _check(pngs_e2e == pngs, "chained encode bytes differ from encode_batch")
    return (mpix / enc_s, mpix / max(dev_s, host_s),
            {"device_s": dev_s, "host_tail_s": host_s, "d2h_s": d2h_s}, pngs)


def _bench_decode(imgs: np.ndarray, pngs, device):
    """(decode MPix/s, stored files skipped, decode path) through the
    dispatch decode_batch ships."""
    from .models.decoder import dispatch_kernel
    from .tools.profile_kernels import decode_inputs

    B, H, W, Cc = imgs.shape
    args, imgs = decode_inputs(pngs, imgs, device)
    skipped = len(pngs) - len(imgs)
    if args is None:
        return 0.0, skipped, "none"
    mpix = len(imgs) * H * W / 1e6
    zmax = int(args[3].max())

    def run():
        out = dispatch_kernel(*args, h=H, w=W, c=Cc, zmax=zmax)
        return out[0], out[1], out[3]

    di, ok, path = run()  # warm
    _check(bool(ok.all()), "device decode rejected a file")
    _check(np.array_equal(di.cpu().numpy(), imgs), "device decode mismatch")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(K_CHAIN):
            di, ok, path = run()
        force1(ok)
        times.append((time.perf_counter() - t0) / K_CHAIN)
    return mpix / min(times), skipped, path


def _bench_serving(imgs: np.ndarray, pngs, flags: int, device,
                   rounds: int = 6):
    """Sustained MPix/s through the public streaming API: chained batches
    through encode_batch_stream / decode_batch_stream, with the container
    work, the copies and the kernels all inside the measured loop."""
    import fpng_tpu_torch as T

    B, H, W, Cc = imgs.shape
    mpix = B * H * W / 1e6
    for _ in T.encode_batch_stream([imgs] * 2, flags, device):  # warm
        pass
    t0 = time.perf_counter()
    n_out = sum(len(out) for out in T.encode_batch_stream(
        [imgs] * rounds, flags, device))
    enc_serving = mpix * rounds / (time.perf_counter() - t0)
    _check(n_out == B * rounds, "encode stream lost batches")

    png_list = list(pngs)
    for _ in T.decode_batch_stream([png_list] * 2, Cc, device):  # warm
        pass
    t0 = time.perf_counter()
    n_ok = sum(sum(s == 0 for s in sts) for sts, _ in T.decode_batch_stream(
        [png_list] * rounds, Cc, device))
    dec_serving = mpix * rounds / (time.perf_counter() - t0)
    _check(n_ok == B * rounds, "decode stream rejected files")
    return enc_serving, dec_serving


def ref_oracle_module():
    """tests/ref_oracle.py (the compiled reference codecs' ctypes wrappers,
    no JAX), loaded by path; None where it is missing."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests", "ref_oracle.py")
    try:
        spec = importlib.util.spec_from_file_location("ref_oracle", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    except (ImportError, OSError):
        return None
    return mod


_REF = None


def _ref_bytes(imgs: np.ndarray, flags: int) -> int:
    """Total compressed size of the corpus through the compiled reference
    encoder, the size-parity gate; 0 when the reference sources are not on
    this machine."""
    global _REF
    if _REF is None:
        mod = ref_oracle_module()
        so = mod._build_ref_shim() if mod else None
        _REF = mod.RefOracle(so) if so else False
    if _REF is False:
        return 0
    return sum(len(_REF.encode(img, flags)) for img in imgs)


def _heldout_classes(ch: int) -> dict:
    """Held-out content classes for the per-class size gate, made with
    seeds and parameters disjoint from train.synthetic_corpus (bench.py's
    classes; its real-tile class needs example.png and is absent here)."""
    rng = np.random.default_rng(0xBEEF + ch)
    h = w = 192
    classes = {}

    def with_alpha(rgb, alpha=None):
        if ch == 3:
            return rgb
        if alpha is None:
            alpha = np.minimum(rgb[..., 1].astype(np.int32) + 96,
                               255).astype(np.uint8)
        return np.concatenate([rgb, alpha[..., None]], axis=-1)

    # photo: 2D integrated noise, wider step range than training (-5..5)
    imgs = []
    for _ in range(8):
        d = rng.integers(-5, 6, (h, w, 3)).cumsum(axis=0).cumsum(axis=1)
        imgs.append(with_alpha((d % 256).astype(np.uint8)))
    classes["photo_noise"] = np.stack(imgs)

    # texture: multi-octave block noise at octaves unseen in training
    imgs = []
    for _ in range(8):
        acc = np.zeros((h, w, 3), np.float64)
        for octave, amp in ((3, 110), (12, 70), (48, 40), (96, 20)):
            g = rng.random((octave, octave, 3)) * amp
            rep = (h + octave - 1) // octave
            acc += np.kron(g, np.ones((rep, rep, 1)))[:h, :w]
        imgs.append(with_alpha((acc % 256).astype(np.uint8)))
    classes["texture_octaves"] = np.stack(imgs)

    # smooth radial gradients (training used linear ramps)
    imgs = []
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(8):
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        r = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
        rgb = np.stack([(r * s) % 256 for s in rng.uniform(0.5, 3.0, 3)],
                       axis=-1).astype(np.uint8)
        imgs.append(with_alpha(rgb))
    classes["radial_gradients"] = np.stack(imgs)
    return classes


def _size_gate_by_class(ch: int, device) -> dict:
    """1-pass size ratio against the compiled reference per held-out class
    (None where the reference is absent)."""
    import fpng_tpu_torch as T

    out = {}
    for name, imgs in _heldout_classes(ch).items():
        ours = sum(len(p) for p in T.encode_batch(imgs, 0, device))
        ref = _ref_bytes(imgs, 0)
        out[name] = ours / ref if ref else None
    return out


def _spot_check(imgs: np.ndarray, pngs, device) -> None:
    """Public-API round trip + an independent zlib / per-row defilter
    reconstruction of the first two files."""
    import fpng_tpu_torch as T

    B, H, W, Cc = imgs.shape
    sts, outs = T.decode_batch(list(pngs[:2]), Cc, device)
    _check(all(s == T.FPNG_DECODE_SUCCESS for s in sts),
           "spot check: decode status")
    _check(all(np.array_equal(o, i) for o, i in zip(outs, imgs[:2])),
           "spot check: decoded pixels")
    for png, img in zip(pngs[:2], imgs[:2]):
        idat_len = int.from_bytes(png[50:54], "big")
        raw = zlib.decompress(png[58:58 + idat_len])
        rows = np.frombuffer(raw, np.uint8).reshape(H, 1 + W * Cc)
        if (rows[:, 0] == 0).all():  # the stored fallback: filter None
            rec = rows[:, 1:]
        else:  # filter Up below the first row
            _check(rows[0, 0] == 0 and (rows[1:, 0] == 2).all(),
                   "spot check: filter bytes")
            rec = np.cumsum(rows[:, 1:].astype(np.int64), axis=0) \
                .astype(np.uint8)
        _check(np.array_equal(rec.reshape(H, W, Cc), img),
               "spot check: zlib reconstruction")


def run(device="cuda", B: int = 128, size: int = 256, only: str | None = None,
        with_4k: bool = True) -> dict:
    """The benchmark's result (the JSON object main prints)."""
    import fpng_tpu_torch as T

    detail = {
        "corpus": (f"{B}x{size}x{size} train.synthetic_corpus tiles, 3ch "
                   "(real3) and 4ch (real4); no example.png, so no "
                   "real-tile corpus; 4K: 2x2160x3840x3 mosaics of the 3ch "
                   "256x256 tiles, rng seed 7"),
        "methodology": (
            "pixels on the card, best of 3 x 4 chained launches: encode = "
            "hist + table build (2-pass) + device encode; encode with "
            "assembly = mpix / max(device encode + IDAT CRC, host tail); "
            "decode = device dispatch after an untimed parse and pack; "
            "serving = the streaming API end to end; baseline numbers are "
            "the reference's end-to-end single-core MPix/s"),
        "card": card_line(device)}
    headline = None
    for kind in ("real3", "real4"):
        if only and kind not in only:
            continue
        imgs = make_corpus(kind, B, size)
        for mode, flags in (("1pass", 0), ("2pass", T.FPNG_ENCODE_SLOWER)):
            if only and mode not in only:
                continue
            enc_mps, enc_e2e, stage_detail, pngs = _bench_encode(
                imgs, flags, device)
            dec_mps, skipped, dec_path = _bench_decode(imgs, pngs, device)
            _spot_check(imgs, pngs, device)
            enc_srv, dec_srv = _bench_serving(imgs, pngs, flags, device)
            agg = 1.0 / (1.0 / enc_mps + 1.0 / dec_mps) if dec_mps else 0.0
            be, bd = BASE[(kind, mode)]
            bagg = 1.0 / (1.0 / be + 1.0 / bd)
            bytes_ours = sum(len(p) for p in pngs)
            bytes_ref = _ref_bytes(imgs, flags)
            # pixel bytes moved per second over the HBM rate (the useful-
            # bytes basis; the stages move more)
            px_b = imgs.size / (imgs.shape[0] * imgs.shape[1] * imgs.shape[2])
            detail[f"{kind}_{mode}"] = {
                "encode_mps": enc_mps,
                "encode_with_assembly_mps": enc_e2e,
                "decode_mps": dec_mps,
                "decode_path": dec_path,
                "encode_serving_mps": enc_srv,
                "decode_serving_mps": dec_srv,
                "aggregate_mps": agg,
                "hbm_util_encode": px_b * enc_mps * 1e6 / _HBM_GBPS,
                "hbm_util_decode": px_b * dec_mps * 1e6 / _HBM_GBPS,
                "bytes": bytes_ours,
                "bytes_ref": bytes_ref,
                "vs_ref_bytes": bytes_ours / bytes_ref if bytes_ref else None,
                "stored_fallbacks": skipped,
                "vs_ref_singlecore": agg / bagg,
                **stage_detail,
            }
            if headline is None or (kind == "real3" and mode == "1pass"):
                headline = (agg, bagg)
        if not only:
            detail[f"size_gate_{kind}"] = _size_gate_by_class(
                3 if kind == "real3" else 4, device)

    if not only and with_4k:
        imgs4k = make_corpus_4k()
        enc_mps, enc_e2e, stage4k, pngs4k = _bench_encode(imgs4k, 0, device)
        dec_mps, skipped4k, path4k = _bench_decode(imgs4k, pngs4k, device)
        _spot_check(imgs4k, pngs4k, device)
        detail["large4k_1pass"] = {
            "shape": "2x2160x3840x3",
            "encode_mps": enc_mps,
            "encode_with_assembly_mps": enc_e2e,
            "decode_mps": dec_mps,
            "decode_path": path4k,
            "stored_fallbacks": skipped4k,
            "bytes": sum(len(p) for p in pngs4k),
            **stage4k,
        }

    agg, bagg = headline
    return {
        "metric": "fpng 1-pass encode+decode aggregate (synthetic tiles)",
        "value": agg,
        "unit": "MPix/s",
        "vs_baseline": agg / bagg,
        "detail": detail,
    }


def main(device="cuda", B: int = 128, size: int = 256) -> int:
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench: no CUDA device")
    kw = dict(device=device, B=B, size=size,
              only=os.environ.get("FPNG_TPU_BENCH_ONLY"),
              with_4k=os.environ.get("FPNG_TPU_BENCH_4K", "1") != "0")
    with profiled(device, "bench"):
        result = run(**kw)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
