"""The walk8 decode against the PK=1 decode on one batch (counterpart of
fpng_tpu's tools/prof_walk8.py).

    python -m fpng_tpu_torch.tools.prof_walk8 [size] [batch] [--device cuda|cpu]

Encodes B synthetic 3-channel tiles of size x size (1-pass), then times
with profile_kernels.chain, on the dynamic-block files: the PK=1 decode
(ops/specdec_tpu.decode_kernel_pk1: B8, B9, B5, B6) and its walk with the
epilogue, then the walk8 decode (ops/walk8.decode_kernel8: B3-B6), its
walk with the epilogue and its finish.  Both decodes are checked against
the input first.  It prints one line a stage and returns the times.
fpng_tpu's lanes-per-image argument sizes the TPU's lane packing; the
port walks ceil(8 zmax / 512) lanes an image, so it has none.
"""

from __future__ import annotations

import argparse

import numpy as np


def stages(size: int = 512, B: int = 32, device="cuda") -> dict:
    """Seconds a call of each stage (chain), and the walks' passes."""
    import fpng_tpu_torch as T
    from ..ops import specdec_tpu as PK
    from ..ops import walk8 as W
    from .profile_kernels import chain, corpus, decode_inputs

    imgs = corpus(size, B)
    (sj, lj, pj, zj), kept = decode_inputs(
        T.encode_batch(imgs, device=device), imgs, device)
    zmax = int(zj.max())
    nc = W.n_chunks(zmax)
    geo = dict(h=size, w=size, c=3)
    t = {"images": len(kept), "lanes": nc}

    def pk1():
        return PK.decode_kernel_pk1(sj, lj, pj, zj, zlib_len_max=zmax, **geo)

    def walk8():
        return W.decode_kernel8(sj, lj, pj, zj, zlib_len_max=zmax, **geo)

    for name, fn, walk in (("pk1", pk1, PK.walk_fix),
                           ("walk8", walk8, W.walk_fix8)):
        n0 = walk.passes
        imgs, ok = fn()[:2]
        t[f"{name}_passes"] = walk.passes - n0
        if imgs is None:  # walk8 overflowed: it returned its entries
            raise RuntimeError(f"prof_walk8: {name} overflowed")
        if not bool(ok.all()) or \
                not np.array_equal(imgs.cpu().numpy(), kept):
            raise RuntimeError(f"prof_walk8: {name} decode mismatch")
    t["pk1_all"] = chain(pk1)
    t["pk1_walk"] = chain(lambda: W.walk_offsets(
        PK.walk_fix, sj, lj, pj, zj, n_chunks=nc))
    t["walk8_all"] = chain(walk8)
    t["walk8_walk"] = chain(lambda: W.decode_walk8(sj, lj, pj, zj,
                                                   n_chunks=nc))
    records, e_fin, out0, steps, _, _ = W.decode_walk8(sj, lj, pj, zj,
                                                       n_chunks=nc)
    k8 = W.trim_steps(int(steps), records[0].shape[1])
    t["walk8_fin"] = chain(lambda: W.finish_decode(
        W.finalize_records8, records, e_fin, out0, zj, k8=k8, **geo))
    t["k8"] = k8
    return t


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="walk8 vs PK=1 decode")
    ap.add_argument("size", type=int, nargs="?", default=512)
    ap.add_argument("batch", type=int, nargs="?", default=32)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(argv)
    t = stages(a.size, a.batch, a.device)
    mpix = t["images"] * a.size * a.size / 1e6
    print(f"corpus {t['images']} dynamic-block files of {a.size}x{a.size}x3 "
          f"= {mpix:.1f} MPix, {t['lanes']} lanes an image")
    for k in ("pk1", "walk8"):
        print(f"{k:5s} all : {t[k + '_all'] * 1e3:8.3f}ms  "
              f"{mpix / t[k + '_all']:7.0f} MP/s  ({t[k + '_passes']} passes)")
        print(f"{k:5s} walk: {t[k + '_walk'] * 1e3:8.3f}ms")
    print(f"walk8 fin : {t['walk8_fin'] * 1e3:8.3f}ms  (k8={t['k8']})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
