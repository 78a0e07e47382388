"""Large-frame bench point (counterpart of fpng_tpu's tools/bench_large.py).

    python -m fpng_tpu_torch.tools.bench_large [B] [H] [W] [--device cuda|cpu]

B frames of H x W x 3 (default 2 x 2160 x 3840: 8.3 MPix a frame) go
through the public encode_batch and decode_batch twice each (the first
call also loads the kernels), must round-trip exactly, and are then timed
with the data on the device by the bench's own methodology
(fpng_tpu_torch.bench: the chained encode with and without the container
assembly, the decode dispatch).  The frames are bench.make_corpus_4k's
mosaics of synthetic tiles, cropped to H x W: fpng_tpu's mosaic of
example.png crops needs a file the port does not read.  It prints one
line a measurement and returns them.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def measure(B: int = 2, H: int = 2160, W: int = 3840, device="cuda") -> dict:
    import fpng_tpu_torch as T
    from .. import bench

    imgs = np.ascontiguousarray(bench.make_corpus_4k(B)[:, :H, :W])
    res = {"shape": [B, H, W, 3], "card": bench.card_line(device)}
    for run in ("first", "second"):
        t0 = time.perf_counter()
        pngs = T.encode_batch(imgs, 0, device)
        res[f"encode_{run}_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        sts, outs = T.decode_batch(pngs, 3, device)
        res[f"decode_{run}_s"] = time.perf_counter() - t0
        if sts != [T.FPNG_DECODE_SUCCESS] * B or not all(
                np.array_equal(o, i) for o, i in zip(outs, imgs)):
            raise RuntimeError("bench_large: round trip mismatch")
    res["bytes"] = [len(p) for p in pngs]
    res["ratio"] = sum(res["bytes"]) / imgs.size
    enc_mps, enc_e2e, stage, pngs2 = bench._bench_encode(imgs, 0, device)
    dec_mps, stored, path = bench._bench_decode(imgs, pngs2, device)
    res.update(encode_mps=enc_mps, encode_with_assembly_mps=enc_e2e,
               decode_mps=dec_mps, decode_path=path, stored_fallbacks=stored,
               **stage)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="large-frame bench point")
    ap.add_argument("B", type=int, nargs="?", default=2)
    ap.add_argument("H", type=int, nargs="?", default=2160)
    ap.add_argument("W", type=int, nargs="?", default=3840)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(argv)
    r = measure(a.B, a.H, a.W, a.device)
    mpix = a.B * a.H * a.W / 1e6
    print(f"corpus: {a.B}x{a.H}x{a.W}x3 = {mpix:.1f} MPix "
          f"({a.H * a.W / 1e6:.1f} MPix a frame) on {r['card']}")
    print(f"public API: encode {r['encode_first_s']:.3f}s first / "
          f"{r['encode_second_s']:.3f}s second, decode "
          f"{r['decode_first_s']:.3f}s / {r['decode_second_s']:.3f}s; "
          f"sizes={r['bytes']} ratio={r['ratio']:.3f}")
    print(f"device-resident: encode {r['encode_mps']:.1f} MP/s  "
          f"encode+assembly {r['encode_with_assembly_mps']:.1f} MP/s  "
          f"decode {r['decode_mps']:.1f} MP/s (path={r['decode_path']}, "
          f"stored={r['stored_fallbacks']})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
