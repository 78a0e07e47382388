"""Probe P2: int8 vs bf16 tensor-core product throughput on the card
(counterpart of fpng_tpu's tools/prof_int8mxu.py).

The TPU probe asked whether s8 x s8 -> s32 dots lower on its matrix unit
and at what rate against bf16.  Here the same product,
out = sum over r < reps of cast(a + r) @ cast(b), runs as the hand-written
wgmma kernel csrc/prof_int8mxu.cu (int8_mxu), T times over, and is timed
with CUDA events.

    python -m fpng_tpu_torch.tools.prof_int8mxu

prints one line per operand type: ms per call and tera-MAC/s, with the
card's name.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels as K

DTYPES = (torch.bfloat16, torch.int8)


def int8_mxu_plain(a: torch.Tensor, b: torch.Tensor, *, dtype,
                   reps: int) -> torch.Tensor:
    """Plain torch version of kernel P2: sum over r < reps of
    cast(a + r) @ cast(b), (128, 128) int32.

    int8 operands wrap mod 256 and their sums are int32 (wrapping); bf16
    operands round to nearest even (int -> float32 -> bfloat16) and their
    float32 sums are truncated to int32.  The products are taken in
    float64, exactly, so the result equals the kernel's and the TPU's
    wherever those float32 sums are exact (every partial sum below 2^24,
    as at the probe's ranges)."""
    if dtype == torch.int8:
        bq = b.to(torch.int8).to(torch.float64)
        acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.int64,
                          device=a.device)
        for r in range(reps):
            ar = (a + r).to(torch.int8).to(torch.float64)
            acc += (ar @ bq).to(torch.int64)
        acc &= 0xFFFFFFFF  # int32 sums wrap
        return torch.where(acc >= 1 << 31, acc - (1 << 32), acc) \
            .to(torch.int32)
    if dtype != torch.bfloat16:
        raise ValueError("int8_mxu: dtype must be torch.int8 or "
                         "torch.bfloat16")
    bq = b.to(torch.float32).to(torch.bfloat16).to(torch.float64)
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32,
                      device=a.device)
    for r in range(reps):
        ar = (a + r).to(torch.float32).to(torch.bfloat16).to(torch.float64)
        acc += (ar @ bq).to(torch.float32)
    return acc.to(torch.int32)  # truncates toward zero


def int8_mxu(a: torch.Tensor, b: torch.Tensor, *, dtype, reps: int,
             T: int) -> torch.Tensor:
    """Kernel P2's wrapper: the product of int8_mxu_plain, done T times on
    the card (each time in full into its own output slot; the last is
    returned).

    a (128, K) and b (K, 128) int32, K a multiple of 32; dtype torch.int8
    or torch.bfloat16.  A CPU tensor takes int8_mxu_plain (T is then
    immaterial); a CUDA tensor launches the kernel (counted in
    `int8_mxu.launches`) or raises.
    """
    if a.device.type == "cpu":
        return int8_mxu_plain(a, b, dtype=dtype, reps=reps)
    return _int8_mxu_slots(a, b, dtype=dtype, reps=reps, T=T)[T - 1]


def _int8_mxu_slots(a, b, *, dtype, reps: int, T: int) -> torch.Tensor:
    """One call of csrc/prof_int8mxu.cu: all T output slots, (T, 128, 128)
    int32 (its first launch stages the operands into scratch, its second
    runs the products)."""
    K.require_cuda("int8_mxu", a, b)
    Kd = a.shape[1]
    if a.shape != (128, Kd) or b.shape != (Kd, 128) or Kd % 32 or \
            dtype not in DTYPES or reps < 0 or not 1 <= T <= 65535:
        raise ValueError("int8_mxu: a (128, K), b (K, 128), K a multiple of "
                         "32, dtype int8 or bfloat16, reps >= 0, "
                         "1 <= T <= 65535")
    bf16 = int(dtype == torch.bfloat16)
    scratch = torch.empty(_scratch_bytes(Kd, bf16), dtype=torch.uint8,
                          device=a.device)
    out = torch.empty((T, 128, 128), dtype=torch.int32, device=a.device)
    K.check(K.lib().fpng_int8mxu(
        a.data_ptr(), b.data_ptr(), Kd, reps, T, bf16, scratch.data_ptr(),
        out.data_ptr(), K.stream_ptr(a.device)), "fpng_int8mxu")
    int8_mxu.launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _scratch_bytes(K_: int, bf16: int) -> int:
    """The kernel's scratch size, from the library (asked once a shape)."""
    return K.lib().fpng_int8mxu_scratch(K_, bf16)


int8_mxu.launches = 0


def inputs(K_: int = 4096, seed: int = 0, device="cuda"):
    """The probe's operands: a in [0, 100), b in {0, 1}, int32."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.integers(0, 100, (128, K_)).astype(np.int32))
    b = torch.from_numpy(rng.integers(0, 2, (K_, 128)).astype(np.int32))
    return a.to(device), b.to(device)


def bench(dtype, K_: int = 4096, reps: int = 8, T: int = 64,
          device="cuda") -> dict:
    """Time one dtype at the probe's size; returns ms per call and
    tera-MAC/s (each call does 128 * K * 128 * reps * T multiply-adds)."""
    from .profile_kernels import chain

    a, b = inputs(K_, device=device)
    dt = chain(lambda: int8_mxu(a, b, dtype=dtype, reps=reps, T=T))
    macs = 128 * K_ * 128 * reps * T
    return {"dtype": str(dtype).replace("torch.", ""), "ms": dt * 1e3,
            "tmac_s": macs / dt / 1e12}


def main(device="cuda") -> int:
    if torch.device(device).type == "cuda":
        print(torch.cuda.get_device_name(0))
    for dt in DTYPES:
        r = bench(dt, device=device)
        print(f"{r['dtype']:9s}: {r['ms']:7.3f}ms  {r['tmac_s']:6.1f} TMAC/s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
