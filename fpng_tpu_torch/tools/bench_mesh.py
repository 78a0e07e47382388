"""Data-parallel corpus throughput over meshes of 1, 2, 4, ... devices
(counterpart of fpng_tpu's tools/bench_mesh.py).

    python -m fpng_tpu_torch.tools.bench_mesh [ndev] [size] [batch-per-device] [--device cuda|cpu]

For each mesh size n (1, then powers of two up to ndev: by default every
card, or 8 shards with --device cpu) it runs the
sharded encode (parallel/mesh.encode_batch_sharded) and the sharded decode
of the dynamic-block files (decode_batch_sharded; the stored-fallback
files decode on the host and are left out, trimmed to a multiple of n)
over the first n cards, once to warm up and once timed on the host
clock, checks the round trip and the training step, and prints one JSON
line: encode, decode and aggregate MPix/s per mesh size, with
scaling_eff = aggregate / (n x the 1-device aggregate).  Its mode is the
device type asked for; "cuda" with more cards than exist raises, and
"cpu" runs n CPU shards (a check of the control flow, not a speed).
The corpus is train.synthetic_corpus's 3-channel tiles
(bench.make_corpus("real3")): fpng_tpu's real-tile corpus needs
example.png, which the port does not read.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def _devices(n: int, device: str) -> list:
    if device == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not 0 < n <= have:
            raise RuntimeError(f"bench_mesh: asked for {n} CUDA devices, "
                               f"have {have}")
        return [f"cuda:{i}" for i in range(n)]
    return [device] * n


def run(n: int, imgs: np.ndarray, device: str) -> dict:
    from ..models.decoder import _parse_one
    from ..parallel import mesh as M

    mesh = M.make_mesh(_devices(n, device))
    B, H, W, Cc = imgs.shape
    M.encode_batch_sharded(mesh, imgs, 0)  # warm
    t0 = time.perf_counter()
    pngs = M.encode_batch_sharded(mesh, imgs, 0)
    enc_s = time.perf_counter() - t0

    keep = [j for j, p in enumerate(pngs) if _parse_one(p)[7] is not None]
    keep = keep[:len(keep) - len(keep) % n]
    files = [pngs[j] for j in keep]
    M.decode_batch_sharded(mesh, files, H, W, Cc)  # warm
    t0 = time.perf_counter()
    dec, ok = M.decode_batch_sharded(mesh, files, H, W, Cc)
    dec_s = time.perf_counter() - t0
    if not ok.all() or not np.array_equal(dec, imgs[keep]):
        raise RuntimeError("bench_mesh: sharded round trip mismatch")
    if int(M.training_step(mesh, M.shard_batch(mesh, imgs), Cc).sum()) <= 0:
        raise RuntimeError("bench_mesh: empty training histogram")
    enc = B * H * W / 1e6 / enc_s
    dec = len(keep) * H * W / 1e6 / dec_s
    return {"encode_mps": enc, "decode_mps": dec,
            "aggregate_mps": 1.0 / (1.0 / enc + 1.0 / dec),
            "decoded_images": len(keep), "encode_s": enc_s,
            "decode_s": dec_s}


def bench(ndev: int | None = None, size: int = 128, bpd: int = 4,
          device: str = "cuda") -> dict:
    """The JSON object main prints; ndev defaults to every card ("cuda")
    or 8 shards ("cpu")."""
    from ..bench import card_line, make_corpus

    if ndev is None:
        ndev = torch.cuda.device_count() if device == "cuda" else 8
    _devices(ndev, device)
    sizes = [1] + [1 << k for k in range(1, ndev.bit_length())]
    imgs = make_corpus("real3", bpd * ndev, size)
    rows = {}
    for n in sizes:
        r = run(n, imgs, device)
        r["scaling_eff"] = r["aggregate_mps"] / (
            rows["1"]["aggregate_mps"] * n if rows else r["aggregate_mps"])
        rows[str(n)] = r
    return {"metric": "mesh-sharded corpus throughput",
            "mode": device, "card": card_line(device),
            "corpus": f"{bpd * ndev}x{size}x{size}x3", "mesh_sizes": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ndev", type=int, nargs="?")
    ap.add_argument("size", type=int, nargs="?", default=128)
    ap.add_argument("bpd", type=int, nargs="?", default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(argv)
    print(json.dumps(bench(a.ndev, a.size, a.bpd, a.device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
