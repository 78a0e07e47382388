"""Device memory of the walk decodes on a card.

    python -m fpng_tpu_torch.tools.decode_memory edge|a|b|epilogue

edge      the raster at fpng_tpu's walk gate's edge, 1 x 5824 x 7680 x 3
          (chip_smoke.py's walk_gate_edge), through each stage of the
          walk8 decode and of the PK=1 decode in turn - the walk, the
          epilogue (walk_offsets), the finalize, B5, B6 - with the peak of
          each stage over what was on the card before the walk (peaks
          reset between stages; what a decode holds stays held), then each
          whole decode's peak
a         case A of chip_smoke.py's memory_plan phase: twelve edge rasters,
          each a mosaic of its own rng seed, encoded one at a time and
          decoded in one decode_batch call on PK=1 (FPNG_TPU_WALK8=0)
b         case B: 2160 x 3840 x 4 mosaics of the 4-channel tiles, 1-pass,
          as many as make the group's zlib pass 200 MB (from frame 0's
          length), encoded eight at a time and decoded in one decode_batch
          call (walk8, then PK=1 on the overflow)
epilogue  the epilogue alone (walk_offsets over a walk's saved outputs),
          by CUDA events, on the headline corpus's walk8 walk and the
          32 bpp 1-pass corpus's PK=1 walk

Each mode prints one JSON line with the card's nvidia-smi name and power
limit.  a and b check every image against its input and print the decode's
peak device bytes; a decode that runs out of card memory raises.  The
script uses only functions whose contracts checkouts since the PK=1 decode
share, so a copy of it in such a checkout measures that checkout.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

import numpy as np

EDGE = (5824, 7680)  # the tallest 7680 x 3 raster fpng_tpu's walk gate admits
FRAME = (2160, 3840)
CASE_A_IMAGES = 12
CASE_B_ZLIB = 200_000_000  # bytes of zlib in case B's group, at least


def tile_grid(H: int, W: int, n_tiles: int, seed: int) -> np.ndarray:
    """The tile index of each 256 x 256 cell of mosaic(H, W, c, seed),
    where train.synthetic_corpus gives n_tiles tiles."""
    rng = np.random.default_rng(seed)
    return np.array([[rng.integers(0, n_tiles) for _ in range(-(-W // 256))]
                     for _ in range(-(-H // 256))])


def mosaic(H: int, W: int, c: int, seed: int) -> np.ndarray:
    """(H, W, c): a mosaic of the c-channel 256 x 256 tiles of
    train.synthetic_corpus drawn row by row with rng seed `seed` (c = 3
    and seed 7 is chip_smoke.py's make_large_raster without its noise)."""
    from ..train import synthetic_corpus

    tiles = [np.ascontiguousarray(t[:256, :256])
             for t in synthetic_corpus(c, size=256)]
    return np.concatenate([np.concatenate([tiles[k] for k in row], axis=1)
                           for row in tile_grid(H, W, len(tiles), seed)],
                          axis=0)[:H, :W]


def case_a(device):
    """(images, PNGs): CASE_A_IMAGES edge rasters, seeds 0, 1, ...; each
    encoded alone."""
    import fpng_tpu_torch as T

    imgs = [mosaic(*EDGE, 3, seed) for seed in range(CASE_A_IMAGES)]
    return imgs, [T.encode_batch(i[None], 0, device)[0] for i in imgs]


def case_b(device):
    """(images, PNGs): FRAME x 4 mosaics, seeds 0, 1, ..., 1-pass, enough
    frames that frame 0's zlib length times their count passes
    CASE_B_ZLIB; encoded eight at a time."""
    import fpng_tpu_torch as T

    first = mosaic(*FRAME, 4, 0)
    z0 = _zlib_len(T.encode_batch(first[None], 0, device)[0])
    n = CASE_B_ZLIB // z0 + 1
    imgs = [first] + [mosaic(*FRAME, 4, seed) for seed in range(1, n)]
    pngs = []
    for i in range(0, n, 8):
        pngs += T.encode_batch(np.stack(imgs[i:i + 8]), 0, device)
    return imgs, pngs


def _zlib_len(png: bytes) -> int:
    """The IDAT length of an fpng file (one IDAT chunk)."""
    return int.from_bytes(png[50:54], "big")


@contextlib.contextmanager
def traced_calls(torch):
    """Record each walk decode that models/decoder.py launches inside the
    block: a list of dicts with the tier, the images, the lanes, whether
    it finished (a walk8 decode that overflows does not: it returns its
    converged entries in place of images, or None in older checkouts), the
    peak device bytes over what was allocated when it started, and the
    absolute peak.  Peaks are reset at each call."""
    from ..models import decoder as TD
    from ..ops.walk8 import n_chunks

    calls = []

    def traced(fn, tier):
        def run(sj, *args, zlib_len_max, **kw):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.memory_allocated()
            out = fn(sj, *args, zlib_len_max=zlib_len_max, **kw)
            torch.cuda.synchronize()
            top = torch.cuda.max_memory_allocated()
            calls.append(dict(tier=tier, images=int(sj.shape[0]),
                              lanes=n_chunks(zlib_len_max),
                              finished=out is not None and
                              out[0] is not None,
                              peak=top - start,
                              top=top))
            return out
        return run

    saved = TD.decode_kernel8, TD.decode_kernel_pk1
    TD.decode_kernel8 = traced(saved[0], "walk8")
    TD.decode_kernel_pk1 = traced(saved[1], "pk1")
    try:
        yield calls
    finally:
        TD.decode_kernel8, TD.decode_kernel_pk1 = saved


def stage_peaks(torch, dargs, nc: int, h: int, w: int, c: int, tier: str):
    """The walk decode of one packed batch (walk8 or pk1) stage by stage,
    each stage's peak device bytes over what was allocated before the
    walk, holding what the decode holds (the records until the end)."""
    from ..ops import specdec_tpu as PK
    from ..ops import walk8 as W
    from ..ops.bitpack import scatter_packed16
    from ..ops.expand import expand

    walk, finalize, ST = ((W.walk_fix8, W.finalize_records8, 8 * W.MAXIT)
                          if tier == "walk8" else
                          (PK.walk_fix, PK.finalize_records, PK.ST8))
    st, lut, p0, zl = dargs
    # positions as the walk takes them (int64 past 2^31 bits; an older
    # checkout has only int32)
    i32 = torch.int32
    pdt = getattr(W, "pos_dtype", lambda n: i32)(nc)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    peaks = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() - base
        return out

    out = stage("walk", lambda: walk(
        W.stream_words(st), lut.to(i32).contiguous(), p0.to(pdt),
        (zl * 8).to(pdt), n_chunks=nc))
    records, e_fin, out0, steps, ovf, _ = stage(
        "epilogue", lambda: W.walk_offsets(lambda *a, **k: out, st, lut, p0,
                                           zl, n_chunks=nc))
    del out
    if bool(ovf.any()):
        raise RuntimeError(f"decode_memory: {tier} overflowed")
    k8 = W.trim_steps(int(steps), ST)
    meta, metb, _ = stage("finalize", lambda: finalize(
        *records, e_fin, out0, k8=k8, h=h, bpl=w * c, c=c))
    raster = stage("b5", lambda: scatter_packed16(meta, metb, h * w * c))
    img = stage("b6", lambda: expand(raster, h=h, w=w, c=c))
    peaks["k8"] = k8
    del records, e_fin, out0, meta, metb, raster
    return img, peaks


def _card(torch):
    from ..bench import card_line

    return dict(card=card_line("cuda"),
                total_bytes=torch.cuda.get_device_properties(0).total_memory)


def edge(torch) -> dict:
    """Stage peaks and whole-decode peaks of the edge raster on walk8 and
    PK=1."""
    import fpng_tpu_torch as T
    from ..models.decoder import _parse_one, pack_streams
    from ..models.transfer import to_device
    from ..ops import specdec_tpu as PK
    from ..ops import walk8 as W

    H, W_ = EDGE
    img = mosaic(H, W_, 3, 7)
    png = T.encode_batch(img[None], 0, "cuda")[0]
    stream, luts, p0, zl = pack_streams([_parse_one(png)])
    dargs = tuple(to_device(a, "cuda")
                  for a in (stream, luts.astype(np.int64), p0, zl))
    nc = W.n_chunks(int(zl.max()))
    res = dict(mode="edge", zlib_bytes=int(zl[0]), lanes=nc)
    for tier, fn in (("walk8", W.decode_kernel8),
                     ("pk1", PK.decode_kernel_pk1)):
        got, res[tier] = stage_peaks(torch, dargs, nc, H, W_, 3, tier)
        if not np.array_equal(got[0].cpu().numpy(), img):
            raise RuntimeError(f"decode_memory: {tier} stages differ")
        del got
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn(*dargs, h=H, w=W_, c=3, zlib_len_max=int(zl.max()))
        torch.cuda.synchronize()
        res[tier]["whole"] = torch.cuda.max_memory_allocated() - base
        if not np.array_equal(out[0][0].cpu().numpy(), img):
            raise RuntimeError(f"decode_memory: {tier} decode differs")
        del out
    return res


def run_case(torch, name: str) -> dict:
    """Case a or b through decode_batch on the card; every image checked
    against its input."""
    import fpng_tpu_torch as T
    from ..models.decoder import decode_batch

    imgs, pngs = (case_a if name == "a" else case_b)("cuda")
    c = imgs[0].shape[2]
    if name == "a":
        os.environ["FPNG_TPU_WALK8"] = "0"
    n0 = getattr(decode_batch, "sub_batches", 0)
    o0 = decode_batch.walk8_overflows
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    t = time.perf_counter()
    try:
        sts, outs = T.decode_batch(pngs, c, device="cuda")
    finally:
        os.environ.pop("FPNG_TPU_WALK8", None)
    seconds = time.perf_counter() - t
    if sts != [0] * len(imgs) or not all(
            np.array_equal(o, i) for o, i in zip(outs, imgs)):
        raise RuntimeError(f"decode_memory: case {name} decode differs")
    return dict(mode=name, images=len(imgs), shape=list(imgs[0].shape),
                zlib_bytes=sum(map(_zlib_len, pngs)), decode_s=seconds,
                peak_bytes=torch.cuda.max_memory_allocated() - start,
                sub_batches=getattr(decode_batch, "sub_batches", 0) - n0,
                walk8_overflows=decode_batch.walk8_overflows - o0)


def epilogue(torch) -> dict:
    """CUDA-event ms of walk_offsets over a walk's saved outputs: the
    headline corpus on walk8 and the 32 bpp 1-pass corpus on PK=1."""
    import fpng_tpu_torch as T
    from .. import bench
    from ..ops import specdec_tpu as PK
    from ..ops import walk8 as W
    from .profile_kernels import decode_inputs

    res = dict(mode="epilogue", rows=getattr(W, "_EPI_ROWS", None))
    for name, kind, walk in (("headline_walk8", "real3", W.walk_fix8),
                             ("real4_1pass_pk1", "real4", PK.walk_fix)):
        imgs = bench.make_corpus(kind)
        (st, lut, p0, zl), _ = decode_inputs(
            T.encode_batch(imgs, 0, "cuda"), imgs, "cuda")
        nc = W.n_chunks(int(zl.max()))
        i32 = torch.int32
        out = walk(W.stream_words(st), lut.to(i32).contiguous(), p0.to(i32),
                   (zl * 8).to(i32), n_chunks=nc)

        def epi():
            return W.walk_offsets(lambda *a, **k: out, st, lut, p0, zl,
                                  n_chunks=nc)

        for _ in range(2):
            epi()
        torch.cuda.synchronize()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(20):
            epi()
        t1.record()
        torch.cuda.synchronize()
        res[name] = dict(ms=t0.elapsed_time(t1) / 20,
                         records=list(out[3].shape))
        del out
    return res


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1 or argv[0] not in ("edge", "a", "b", "epilogue"):
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("decode_memory: needs a CUDA device")
    mode = argv[0]
    res = (edge(torch) if mode == "edge" else
           epilogue(torch) if mode == "epilogue" else run_case(torch, mode))
    print(json.dumps(dict(res, **_card(torch))), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
