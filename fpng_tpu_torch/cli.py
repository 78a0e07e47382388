"""fpng_tpu_torch benchmark / test / fuzz / training CLI (counterpart of
fpng_tpu/cli.py, fpng_test parity).  Everything runs on the CUDA card
unless main(..., device="cpu") asks for the CPU.

Usage:  python -m fpng_tpu_torch.cli [options]
            <file.png | directory | @filelist>

Modes (reference flags, fpng_test.cpp:984-991):
  (default)   roundtrip-verify + benchmark one file or a corpus
  -s          2-pass mode (FPNG_ENCODE_SLOWER)
  -u          force uncompressed (stored blocks)
  -a          swizzle green into alpha (32bpp stress corpus)
  -A <file>   second file: its green becomes each image's alpha
              (fpng_test.cpp:1125-1146 second-argument mode)
  -c          CSV output (schema mirrors fpng_test.cpp:1625-1632)
  -e          encoder fuzz: structured corruptions of a real image
  -E          encoder fuzz: random dims + random pixels
  -f          decoder fuzz: decode the file, report status (zzuf-style)
  -t          training mode: retrain 1-pass tables on @filelist / directory
  -b N        device batch size (default 8)
  -n N        fuzz trial count (default 1000)
  -d N        fuzz max dimension (default 8193, reference parity)

Timing is best-of-3 encode / best-of-5 decode like the reference
(fpng_test.cpp:1181-1182); throughput in MPix/s (1024*1024 pixels).
FPNG_TPU_PROFILE=<dir> writes a torch.profiler trace of the batched
summary there.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from . import constants as C
from .utils.pngreader import PngError


def _load_source(path: str, desired: int = 4):
    """(rgba or rgb, w, h, channels in file); raises OSError or PngError."""
    from .utils.pngreader import load_png

    with open(path, "rb") as f:
        data = f.read()
    img, w, h, ch = load_png(data, desired)
    return img, w, h, ch


def _gather_files(arg: str) -> list[str]:
    if arg.startswith("@"):
        with open(arg[1:]) as f:
            return [ln.strip() for ln in f if ln.strip()]
    if os.path.isdir(arg):
        return sorted(
            os.path.join(arg, n) for n in os.listdir(arg)
            if n.lower().endswith(".png"))
    return [arg]


def _has_alpha(rgba: np.ndarray) -> bool:
    return bool((rgba[..., 3] != 255).any())


def _best_of(fn, n: int) -> float:
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _load_oracles():
    """Comparison codecs compiled from the reference's vendored copies
    (tests/ref_oracle.py; fpng_test.cpp:1329-1606).  Returns (ref, codecs)
    - either may be None when the reference sources or the toolchain are
    unavailable."""
    from .bench import ref_oracle_module

    mod = ref_oracle_module()
    if mod is None:
        return None, None
    so = mod._build_ref_shim()
    cso = mod._build_codecs_shim()
    return (mod.RefOracle(so) if so else None,
            mod.CodecsOracle(cso) if cso else None)


def bench_corpus(paths: list[str], flags: int, swizzle: bool, csv: bool,
                 batch: int, alpha_file: str | None = None,
                 device="cuda") -> int:
    """Per-file best-of-N benchmark vs the comparison codecs, plus a
    batched corpus-throughput summary (the device's operating point).

    CSV rows mirror fpng_test.cpp:1625-1632 exactly:
      filename, w, h, chans,
      qoi: enc_t, MB, dec_t, enc_mps, dec_mps,
      fpng(_tpu): ..., lodepng: ..., stbi: ..., pvpng: dec_t, dec_mps
    """
    import fpng_tpu_torch as T
    from .tools.profile_kernels import profiled

    MPIX = 1024.0 * 1024.0
    alpha_img = None
    if alpha_file is not None:
        # second-file mode: its green channel becomes each image's alpha
        # (the reference harness's 32bpp stress generator,
        # fpng_test.cpp:1125-1146; dims must match)
        alpha_img, _, _, _ = _load_source(alpha_file)
    images = []
    for p in paths:
        try:
            rgba, w, h, ch = _load_source(p)
        except (OSError, PngError) as e:
            print(f"skip {p}: {e}", file=sys.stderr)
            continue
        if alpha_img is not None:
            if alpha_img.shape[:2] != rgba.shape[:2]:
                print(f"skip {p}: alpha file dims differ", file=sys.stderr)
                continue
            rgba = rgba.copy()
            rgba[..., 3] = alpha_img[..., 1]
        elif swizzle:
            rgba = rgba.copy()
            rgba[..., 3] = rgba[..., 1]
        chans = 4 if _has_alpha(rgba) else 3
        img = rgba if chans == 4 else np.ascontiguousarray(rgba[..., :3])
        images.append((p, img))
    if not images:
        return 1

    ref, codecs = _load_oracles()
    from .utils.pngreader import load_png

    tot = {k: [0.0, 0.0, 0] for k in
           ("qoi", "fpng", "lodepng", "stbi", "pvpng", "ref_fpng",
            "wuffs")}
    total_px = 0
    # warm up each shape's first device call (untimed)
    seen_shapes = set()
    for p, img in images:
        if img.shape not in seen_shapes:
            seen_shapes.add(img.shape)
            T.encode_batch(img[None], flags, device)

    for p, img in images:
        h, w, chn = img.shape
        mp = w * h / MPIX
        total_px += w * h
        row = [p, w, h, chn]

        def _codec(enc, dec, verify=None):
            data = enc()
            if data is None:
                return ["", "", "", "", ""]
            et = _best_of(enc, 3)
            out = dec(data)
            dt = _best_of(lambda: dec(data), 5) if out is not None else 0.0
            if verify is not None and out is not None and \
                    not verify(out):
                print(f"VERIFY FAILED: {p}", file=sys.stderr)
                raise SystemExit(1)
            return [f"{et:.6f}", f"{len(data) / MPIX:.6f}", f"{dt:.6f}",
                    f"{mp / et:.3f}", f"{mp / dt:.3f}" if dt else ""]

        def acc(key, cols):
            if cols[0]:
                tot[key][0] += float(cols[0])
                tot[key][2] += 1
            if cols[2]:
                tot[key][1] += float(cols[2])

        # qoi (its own format, like the reference harness)
        if codecs:
            cols = _codec(lambda: codecs.qoi_encode(img),
                          lambda d: codecs.qoi_decode(d, chn),
                          lambda o: np.array_equal(o, img))
            acc("qoi", cols)
        else:
            cols = [""] * 5
        row += cols

        # fpng_tpu_torch (batched API, B=1 per file for per-file stats)
        fpng_png = {}

        def enc_fpng():
            out = T.encode_batch(img[None], flags, device)
            fpng_png["d"] = out[0]
            return out[0]

        def dec_fpng(d):
            sts, outs = T.decode_batch([d], chn, device)
            return outs[0] if sts[0] == C.FPNG_DECODE_SUCCESS else None

        cols = _codec(enc_fpng, dec_fpng,
                      lambda o: np.array_equal(o, img))
        acc("fpng", cols)
        row += cols
        png = fpng_png["d"]

        if ref is not None:
            # compiled reference fpng on the same pixels (not a CSV
            # column - the reference's own CSV doesn't have it)
            t0 = time.perf_counter()
            rp = ref.encode(img, flags & ~C.FPNG_FORCE_UNCOMPRESSED)
            ret = time.perf_counter() - t0
            if rp is not None:
                ref.decode(png, chn)
                t0 = time.perf_counter()
                ref.decode(png, chn)
                rdt = time.perf_counter() - t0
                tot["ref_fpng"][0] += ret
                tot["ref_fpng"][1] += rdt
                tot["ref_fpng"][2] += 1

        # lodepng (encodes comparison file; decodes OUR png)
        if ref is not None:
            cols = _codec(lambda: ref.lodepng_encode(img),
                          lambda _d: ref.lodepng_decode(png)[1])
            acc("lodepng", cols)
        else:
            cols = [""] * 5
        row += cols

        # stb (encodes comparison file; decodes OUR png)
        if codecs:
            cols = _codec(lambda: codecs.stbi_write_png(img),
                          lambda _d: codecs.stbi_load(png, chn),
                          lambda o: np.array_equal(o, img))
            acc("stbi", cols)
        else:
            cols = [""] * 5
        row += cols

        # pvpng-equivalent: our general PNG reader decoding OUR png
        t0 = time.perf_counter()
        out, *_ = load_png(png, chn)
        pvt = time.perf_counter() - t0
        if not np.array_equal(out, img):
            print(f"VERIFY FAILED (pngreader): {p}", file=sys.stderr)
            return 1
        tot["pvpng"][1] += pvt
        row += [f"{pvt:.6f}", f"{mp / pvt:.3f}"]

        # wuffs decodes every benchmarked output (the strictest public
        # PNG decoder, timed like the reference: fpng_test.cpp:1402-1445)
        if codecs is not None:
            st_w, wout = codecs.wuffs_decode(png)
            if st_w != 0:
                print(f"VERIFY FAILED (wuffs reject): {p}", file=sys.stderr)
                return 1
            exp = img if chn == 4 else np.concatenate(
                [img, np.full((h, w, 1), 255, np.uint8)], axis=2)
            if not np.array_equal(wout, exp):
                print(f"VERIFY FAILED (wuffs pixels): {p}", file=sys.stderr)
                return 1
            wt = _best_of(lambda: codecs.wuffs_decode(png), 5)
            tot["wuffs"][1] += wt
            row += [f"{wt:.6f}", f"{mp / wt:.3f}"]
        else:
            row += ["", ""]

        if csv:
            print(", ".join(str(x) for x in row))

    mp_all = total_px / MPIX
    if not csv:
        print(f"files: {len(images)}  pixels: {mp_all:.2f} MPix")
        print("** Per-file best-of-N totals:")
        names = {"fpng": "FPNG_TPU", "ref_fpng": "fpng(ref)",
                 "lodepng": "lodepng", "stbi": "stbi", "qoi": "qoi"}
        for k, label in names.items():
            et, dt, n = tot[k]
            if n == 0:
                continue
            print(f"{label:10s} enc {et:9.6f}s {mp_all / et:8.3f} MP/s   "
                  f"dec {dt:9.6f}s {mp_all / dt if dt else 0:8.3f} MP/s")
        dt = tot["pvpng"][1]
        print(f"{'pvpng':10s} {'':26s}dec {dt:9.6f}s "
              f"{mp_all / dt if dt else 0:8.3f} MP/s")
        dt = tot["wuffs"][1]
        if dt:
            print(f"{'wuffs':10s} {'':26s}dec {dt:9.6f}s "
                  f"{mp_all / dt:8.3f} MP/s")

        # batched corpus throughput: B images of one shape per device
        # call.  fpng_tpu also picks its TPU lane-bucket density here
        # (autotune_density); the port's walk sizes its lanes itself.
        from collections import defaultdict

        buckets = defaultdict(list)
        for i, (p, img) in enumerate(images):
            buckets[img.shape].append(i)
        enc_t = dec_t = 0.0
        with profiled(device, "cli"):
            for shape, idxs in buckets.items():
                for s in range(0, len(idxs), batch):
                    part = idxs[s:s + batch]
                    arr = np.stack([images[i][1] for i in part])
                    T.encode_batch(arr, flags, device)
                    enc_t += _best_of(
                        lambda: T.encode_batch(arr, flags, device), 3)
                    out = T.encode_batch(arr, flags, device)
                    T.decode_batch(out, shape[2], device)
                    dec_t += _best_of(
                        lambda: T.decode_batch(out, shape[2], device), 5)
        print(f"** Batched (B={batch}): encode {mp_all / enc_t:.2f} MP/s  "
              f"decode {mp_all / dec_t:.2f} MP/s")
    return 0


def fuzz_encoder_structured(path: str, trials: int = 1000, seed: int = 1000,
                            device="cuda") -> int:
    """-e analog: corrupt a real image in structured ways, encode, verify
    (fpng_test.cpp:381-615)."""
    import fpng_tpu_torch as T

    rgba, w, h, ch = _load_source(path)
    rng = np.random.default_rng(seed)
    for trial in range(trials):
        img = rgba.copy()
        mode = trial % 5
        n = int(rng.integers(1, 32))
        for _ in range(n):
            y = int(rng.integers(0, h))
            x = int(rng.integers(0, w))
            ln = int(rng.integers(1, max(2, w - x)))
            if mode == 0:
                img[y, x:x + ln] = rng.integers(0, 256, 4, dtype=np.uint8)
            elif mode == 1:
                img[y, x:x + ln] ^= rng.integers(0, 256, 4, dtype=np.uint8)
            elif mode == 2:
                img[y, x:x + ln] = int(rng.integers(0, 256))
            elif mode == 3:
                img.reshape(-1)[int(rng.integers(0, img.size))] ^= \
                    1 << int(rng.integers(0, 8))
            else:
                img = rng.integers(0, 256, img.shape, dtype=np.uint8)
        chans = 4 if _has_alpha(img) else 3
        src = img if chans == 4 else np.ascontiguousarray(img[..., :3])
        for flags in (0, C.FPNG_ENCODE_SLOWER):
            png = T.fpng_encode_image_to_memory(src, w, h, chans, flags,
                                                device)
            st, out, *_ = T.fpng_decode_memory(png, chans, device)
            if st != 0 or not np.array_equal(out, src):
                print(f"FUZZ FAIL trial {trial} flags {flags}")
                return 1
        if trial % 100 == 0:
            print(f"trial {trial}", file=sys.stderr)
    print(f"encoder fuzz: {trials} trials OK")
    return 0


def fuzz_encoder_random(trials: int = 1000, seed: int = 1000,
                        max_dim: int = 8193, device="cuda") -> int:
    """-E analog: random dims + random pixels roundtrip, dims 1..8193
    like the reference (fpng_test.cpp:617-682).

    The first trials pin the pathological corners (1 x max, max x 1,
    budget-edge shapes) so any run length covers them; the rest draw
    dims log-uniformly - the full range is exercised without every
    trial averaging 16 MPix.
    """
    import fpng_tpu_torch as T

    corners = [(1, max_dim), (max_dim, 1), (1, 1), (2, max_dim - 1),
               (max_dim // 2, 2), (7, 4096), (4097, 3)]
    rng = np.random.default_rng(seed)
    for trial in range(trials):
        if trial < len(corners):
            w, h = corners[trial]
        else:
            w = int(np.exp(rng.uniform(0, np.log(max_dim))))
            h = int(np.exp(rng.uniform(0, np.log(max_dim))))
            w, h = max(w, 1), max(h, 1)
        ch = int(rng.choice([3, 4]))
        img = rng.integers(0, 256, (h, w, ch), dtype=np.uint8)
        if rng.random() < 0.5:  # bias toward compressible content
            img[:: max(1, h // 3)] = img[0, 0]
        flags = int(rng.choice([0, C.FPNG_ENCODE_SLOWER,
                                C.FPNG_FORCE_UNCOMPRESSED]))
        png = T.fpng_encode_image_to_memory(img, w, h, ch, flags, device)
        st, out, *_ = T.fpng_decode_memory(png, ch, device)
        if st != 0 or not np.array_equal(out, img):
            print(f"FUZZ FAIL trial {trial} {w}x{h}x{ch} flags {flags}")
            return 1
        if trial % 100 == 0:
            print(f"trial {trial}", file=sys.stderr)
    print(f"random-dims fuzz: {trials} trials OK")
    return 0


def fuzz_decode_file(path: str, device="cuda") -> int:
    """-f analog: decode one (possibly corrupted) file; never crash."""
    import fpng_tpu_torch as T
    from .utils.pngreader import load_png

    with open(path, "rb") as f:
        data = f.read()
    st, out, w, h, ch = T.fpng_decode_memory(data, 4, device)
    print(f"status={st} w={w} h={h} ch={ch}")
    if st == C.FPNG_DECODE_NOT_FPNG:
        try:
            img, w, h, ch = load_png(data, 4)
            print(f"general decoder: {w}x{h} ch={ch}")
        except PngError as e:
            print(f"general decoder rejected: {e}")
    return 0


def train(paths: list[str]) -> int:
    from .tables import accumulate_image_freqs, train_tables_from_freqs

    freqs = {3: np.zeros(288, np.uint64), 4: np.zeros(288, np.uint64)}
    counts = {3: 0, 4: 0}
    for p in paths:
        try:
            rgba, w, h, ch = _load_source(p)
        except (OSError, PngError) as e:
            print(f"skip {p}: {e}", file=sys.stderr)
            continue
        chans = 4 if _has_alpha(rgba) else 3
        img = rgba if chans == 4 else np.ascontiguousarray(rgba[..., :3])
        accumulate_image_freqs(img, freqs[chans])
        counts[chans] += 1
    print(f"trained on {counts[3]} opaque / {counts[4]} alpha files")
    for chv in (3, 4):
        if counts[chv]:
            art = train_tables_from_freqs(freqs[chv], chv)
            print(f"{chv}ch prefix: {len(art[0])} bytes")
    return 0


def main(argv: list[str] | None = None, device="cuda") -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    flags = 0
    swizzle = csv = False
    mode = "bench"
    batch = 8
    trials = 1000
    max_dim = 8193
    alpha_file: str | None = None
    files: list[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-s":
            flags |= C.FPNG_ENCODE_SLOWER
        elif a == "-u":
            flags |= C.FPNG_FORCE_UNCOMPRESSED
        elif a == "-a":
            swizzle = True
        elif a == "-c":
            csv = True
        elif a == "-e":
            mode = "fuzz_e"
        elif a == "-E":
            mode = "fuzz_E"
        elif a == "-f":
            mode = "fuzz_f"
        elif a == "-t":
            mode = "train"
        elif a == "-b":
            i += 1
            batch = int(argv[i])
        elif a == "-n":
            i += 1
            trials = int(argv[i])
        elif a == "-d":
            i += 1
            max_dim = int(argv[i])
        elif a == "-A":
            i += 1
            alpha_file = argv[i]
        else:
            files.append(a)
        i += 1

    if mode == "fuzz_E":
        return fuzz_encoder_random(trials=trials, max_dim=max_dim,
                                   device=device)
    if not files:
        print(__doc__)
        return 2
    paths = [q for f in files for q in _gather_files(f)]
    if mode == "fuzz_e":
        return fuzz_encoder_structured(paths[0], trials=trials,
                                       device=device)
    if mode == "fuzz_f":
        return fuzz_decode_file(paths[0], device)
    if mode == "train":
        return train(paths)
    return bench_corpus(paths, flags, swizzle, csv, batch,
                        alpha_file=alpha_file, device=device)


if __name__ == "__main__":
    sys.exit(main())
