"""Chained-call timing for the probes and the bench (counterpart of
fpng_tpu's tools/profile_kernels.py: chain and force1).

chain(f, *a) times K chained calls after a warm one.  On a CUDA device it
brackets the chain with two CUDA events and synchronises once, so the time
is the device's and not the host's enqueue; on the CPU it takes the host
clock, ending with force1 on the last result.

profiled(device, name) is the harness's FPNG_TPU_PROFILE=<dir> switch: a
torch.profiler trace of the block, written as <dir>/<name>_trace.json (a
Chrome trace).

fpng_tpu's per-stage profiler (its main) times TPU-only stages (plan_tpu,
_decode_walk) and is not ported yet.
"""

from __future__ import annotations

import contextlib
import os
import time

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
    directory (the card's kernels too on a CUDA device); else do nothing."""
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
