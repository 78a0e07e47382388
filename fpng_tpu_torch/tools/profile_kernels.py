"""Chained-call timing and the per-stage profiler (counterpart of
fpng_tpu's tools/profile_kernels.py).

    python -m fpng_tpu_torch.tools.profile_kernels [size] [batch] [--device cuda|cpu]

chain(f, *a) times K chained calls after a warm one.  On a CUDA device it
brackets the chain with two CUDA events and synchronises once, so the time
is the device's and not the host's enqueue; on the CPU it takes the host
clock, ending with force1 on the last result.

profiled(device, name) is the harness's FPNG_TPU_PROFILE=<dir> switch: a
torch.profiler trace of the block, written as <dir>/<name>_trace.json (a
Chrome trace).  The session turns on the program's own spans
(utils/trace.py), so the trace shows its stages as ranges - `decoder.*`,
`encoder.*`, `transfer.*`, `mesh.*` - over the card's kernels.

main times the port's own stages on a batch of synthetic tiles with
chain: the encode's build_desc prologue, kernel B1 and the whole
encode_kernel; the walk8 decode whole, its walk with the epilogue
(decode_walk8: B3), its finish (B4, B5, B6) and each of those three
kernels alone.  It prints one line a stage and returns the times.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np
import torch


def _first_tensor(x) -> torch.Tensor:
    while isinstance(x, (tuple, list)):
        x = x[0]
    return x


def force1(x):
    """Read the last element of x (of its first tensor, for a tuple or a
    list) back to the host: waits for the work that produced it."""
    return _first_tensor(x).reshape(-1)[-1].item()


def chain(f, *a, K: int = 10) -> float:
    """Mean seconds per call of f(*a) over K chained calls, after one
    warm-up call."""
    r = f(*a)
    force1(r)
    if _first_tensor(r).device.type == "cuda":
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(K):
            f(*a)
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) / K / 1e3
    t = time.perf_counter()
    for _ in range(K):
        r = f(*a)
    force1(r)
    return (time.perf_counter() - t) / K


@contextlib.contextmanager
def profiled(device, name: str):
    """Trace the block with torch.profiler when FPNG_TPU_PROFILE names a
    directory (the card's kernels too on a CUDA device, and the program's
    stage ranges); else do nothing."""
    prof_dir = os.environ.get("FPNG_TPU_PROFILE")
    if not prof_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(prof_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(prof_dir, f"{name}_trace.json"))


def corpus(size: int, B: int) -> np.ndarray:
    """B 3-channel synthetic tiles (bench.make_corpus("real3")), tiled
    2 x 2 until they reach size x size."""
    from ..bench import make_corpus

    imgs = make_corpus("real3", B, min(size, 256))
    while imgs.shape[1] < size:
        imgs = np.tile(imgs, (1, 2, 2, 1))
    return np.ascontiguousarray(imgs[:, :size, :size])


def decode_inputs(pngs, imgs, device):
    """The dynamic-block files of a batch packed as decode_batch packs
    them, on `device`: ((stream, lut, p0, zlib_len), their images), or
    (None, no images) where every file is stored."""
    from ..models.decoder import _parse_one, pack_streams
    from ..models.transfer import to_device

    metas = [_parse_one(p) for p in pngs]
    keep = [j for j, m in enumerate(metas) if m[7] is not None]
    if not keep:
        return None, imgs[:0]
    stream, luts, p0, zl = pack_streams([metas[j] for j in keep])
    args = tuple(to_device(a, device)
                 for a in (stream, luts.astype(np.int64), p0, zl))
    return args, imgs[keep]


def stages(size: int = 512, B: int = 32, device="cuda") -> dict:
    """Seconds a call of each stage at B x size x size x 3 (chain)."""
    import fpng_tpu_torch as T
    from ..models.encoder import _budget, _num_words, build_desc, \
        encode_kernel
    from ..ops import walk8 as W
    from ..ops.bitpack import scatter_packed16
    from ..ops.encfuse import encode_bits_fused
    from ..ops.expand import expand
    from ..tables import one_pass_state

    imgs = corpus(size, B)
    H = Wd = size
    Cc = 3
    st = one_pass_state(Cc, device)
    dev = torch.from_numpy(imgs).to(device)

    def col(v):
        return torch.full((B,), v, dtype=torch.int32, device=device)

    codes, sizes = st.codes.expand(B, -1), st.sizes.expand(B, -1)
    bb, pv, pn = col(len(st.prefix) * 8), col(st.acc), col(st.nacc)
    num_words = _num_words(_budget(H, Wd, Cc))
    t = {}

    def desc_fn():
        return build_desc(dev, codes, sizes, pv, pn, num_chans=Cc,
                          cost_check=False)

    t["enc_desc"] = chain(desc_fn)
    desc, tbl = desc_fn()[:2]
    t["enc_fuse"] = chain(lambda: encode_bits_fused(desc, tbl, bb,
                                                    num_words))
    t["enc_full"] = chain(lambda: encode_kernel(
        dev, codes, sizes, bb, pv, pn, num_chans=Cc, cost_check=False,
        want_hist=False, num_words=num_words))

    (sj, lj, pj, zj), kept = decode_inputs(
        T.encode_batch(imgs, device=device), imgs, device)
    zmax = int(zj.max())

    def dec_all():
        return W.decode_kernel8(sj, lj, pj, zj, h=H, w=Wd, c=Cc,
                                zlib_len_max=zmax)

    imgs_d, ok, _ = dec_all()
    if imgs_d is None or not bool(ok.all()) or \
            not np.array_equal(imgs_d.cpu().numpy(), kept):
        raise RuntimeError("profile_kernels: walk8 decode mismatch")
    t["dec_all"] = chain(dec_all)
    nc = W.n_chunks(zmax)

    def walk():
        return W.decode_walk8(sj, lj, pj, zj, n_chunks=nc)

    t["dec_walk"] = chain(walk)
    records, e_fin, out0, steps, _, _ = walk()
    k8 = W.trim_steps(int(steps), records[0].shape[1])
    bpl = Wd * Cc
    t["dec_fin"] = chain(lambda: W.finish_decode(
        W.finalize_records8, records, e_fin, out0, zj, k8=k8, h=H, w=Wd,
        c=Cc))

    def fz():
        return W.finalize_records8(*records, e_fin, out0, k8=k8, h=H,
                                   bpl=bpl, c=Cc)

    t["dec_fz"] = chain(fz)
    meta, metb, _ = fz()
    t["dec_dep"] = chain(lambda: scatter_packed16(meta, metb, H * bpl))
    raster = scatter_packed16(meta, metb, H * bpl)
    t["dec_exp"] = chain(lambda: expand(raster, h=H, w=Wd, c=Cc))
    return t


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="per-stage kernel profiler")
    ap.add_argument("size", type=int, nargs="?", default=512)
    ap.add_argument("batch", type=int, nargs="?", default=32)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(argv)
    mpix = a.batch * a.size * a.size / 1e6
    print(f"corpus {a.batch}x{a.size}x{a.size}x3 = {mpix:.1f} MPix")
    for name, s in stages(a.size, a.batch, a.device).items():
        rate = f"  {mpix / s:7.0f} MP/s" if name in (
            "enc_desc", "enc_fuse", "enc_full", "dec_all") else ""
        print(f"{name:9s}: {s * 1e3:7.3f}ms{rate}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
