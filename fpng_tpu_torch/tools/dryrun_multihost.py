"""Multi-process corpus-sharding dry run (counterpart of fpng_tpu's
tools/dryrun_multihost.py).

Each process of one torch.distributed group holds only its slice of a
seeded corpus, splits it into 4 local shards, and runs the mesh's
training step (parallel/mesh.training_step): the per-shard histograms are
summed locally and then all-reduced over the group, so the one collective
crosses the process boundary.  Each process checks the result against
the full corpus's histogram computed alone.

    python -m fpng_tpu_torch.tools.dryrun_multihost              # NCCL, 1 rank on cuda:0
    python -m fpng_tpu_torch.tools.dryrun_multihost --device cpu # gloo, 2 CPU processes

The group meets at tcp://127.0.0.1:<port>, the port taken from
FPNG_TPU_TORCH_MH_PORT or else a free one.  NCCL refuses two ranks on one
GPU, so on a card the world is one process.  The parent prints each
process's output, then "MULTIHOST DRYRUN: OK" or "FAILED", and exits
non-zero on failure.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SHARDS_PER_PROC = 4
TIMEOUT_S = 600


def corpus() -> np.ndarray:
    """The seeded corpus: 8 x 24 x 24 x 3, rows 6-10 a flat band."""
    rng = np.random.default_rng(7)
    full = rng.normal(128, 12, (8, 24, 24, 3)).clip(0, 255).astype(np.uint8)
    full[:, 6:10] = 77
    return full


def child(rank: int, world: int, port: int, device: str) -> int:
    import torch
    import torch.distributed as dist

    from ..models.encoder import hist_kernel
    from ..parallel.mesh import make_mesh, training_step

    cuda = device == "cuda"
    if cuda:
        torch.cuda.set_device(0)
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        dev = "cuda:0" if cuda else "cpu"
        full = corpus()
        n = len(full) // world
        local = full[rank * n:(rank + 1) * n]
        mesh = make_mesh([dev] * SHARDS_PER_PROC)
        ghist = training_step(mesh, local, full.shape[3])
        want = hist_kernel(torch.from_numpy(full).to(dev),
                           num_chans=full.shape[3]).sum(0)
        if not torch.equal(ghist, want):
            print(f"proc {rank}: all-reduced histogram differs")
            return 1
        print(f"proc {rank}: global hist ok ({int(ghist.sum())} tokens, "
              f"world {world}, {dist.get_backend()})")
        return 0
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parent(device: str) -> int:
    world = 1 if device == "cuda" else 2
    port = int(os.environ.get("FPNG_TPU_TORCH_MH_PORT") or free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-m", "fpng_tpu_torch.tools.dryrun_multihost",
         "child", str(rank), str(world), str(port), "--device", device],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(world)]
    rc = 0
    try:
        for rank, p in enumerate(procs):
            out, _ = p.communicate(timeout=TIMEOUT_S)
            ok = p.returncode == 0 and "hist ok" in out
            print(f"--- process {rank} (rc={p.returncode}) ---")
            print(out.strip()[-2000:])
            rc |= 0 if ok else 1
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
                rc = 1
    print("MULTIHOST DRYRUN:", "OK" if rc == 0 else "FAILED", flush=True)
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("role", nargs="*",
                    help="internal: child RANK WORLD PORT")
    a = ap.parse_args(argv)
    if a.role:
        _, rank, world, port = a.role
        return child(int(rank), int(world), int(port), a.device)
    return parent(a.device)


if __name__ == "__main__":
    raise SystemExit(main())
