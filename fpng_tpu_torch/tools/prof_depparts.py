"""Probe P1: the parts of a one-hot deposit on the card - building the
one-hot against the tensor-core product (counterpart of fpng_tpu's
tools/prof_depparts.py).

The TPU probe split its deposit's cost into the one-hot build and the int8
matrix-unit dot.  Here the same steps run as the hand-written kernel
csrc/prof_depparts.cu (depparts): per step (b, t) of a B x T grid, WPS
walks of 4096 units each; the modes price the parts (the kernel's header
has the table).  Importing this module runs nothing:

    python -m fpng_tpu_torch.tools.prof_depparts

times each mode of MODE (environment; "all" by default: full, ohc, dot,
dotbf16, none) at the probe's size and prints ms per call.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from .. import kernels as K

B, T, WPS = 32, 18, 4  # batches, grid steps, walks per step
GROUP = 4096           # units per walk: 32 rows of 128 of cu
M = 136                # rows of big (the TPU's wrows(17) * Pp(8))
MAX_WPS = 32           # walks a step the kernel takes
MODES = ("full", "ohc", "dot", "dotbf16", "none")  # the probe's "all"
# mode -> (source of the one-hot: 0 cu, 1 ohc0; product: 0 none, 1 int8,
# 2 bf16); fulli8cmp and fullbf16 differ from full only in TPU operand types
_ROUTES = {"full": (0, 1), "fulli8cmp": (0, 1), "fullbf16": (0, 2),
           "ohc": (0, 0), "dot": (1, 1), "dotbf16": (1, 2), "none": (1, 0)}
ALL_MODES = tuple(_ROUTES)


def slot_columns(m: torch.Tensor) -> torch.Tensor:
    """The probe's slot arithmetic on int32 m: word = (m << 4) >> 5 (int32,
    wrapping), then word & 127, or -1 where the word is negative."""
    word = ((m.to(torch.int64) << 4) & 0xFFFFFFFF)
    word = torch.where(word >= 1 << 31, word - (1 << 32), word) >> 5
    return torch.where(word >= 0, word & 127, -1)


def depparts_plain(cu: torch.Tensor, big: torch.Tensor, ohc0: torch.Tensor,
                   mode: str) -> torch.Tensor:
    """Plain torch version of kernel P1: the (B, 8, 128) int32 output of
    step t = T-1, computed directly (a scatter-add over the slot columns
    for the one-hot modes, no one-hot tile).  The bf16 modes equal the
    int8 ones wherever their float32 sums are exact (below 2^24, as at the
    probe's ranges), so they are computed exactly too."""
    src, prod = _ROUTES[mode]
    Bn, _, R, _ = cu.shape
    wps = R // 32
    dev = cu.device
    out = torch.zeros((Bn, 8, 128), dtype=torch.int64, device=dev)
    if src == 1:
        o8 = ohc0[:, :8].to(torch.int64)
        if prod == 0:
            return (wps * o8).to(torch.int32)
        oh = ohc0.to(torch.float64)
        for k in range(wps):  # float64 products and sums: exact here
            out += (big[:, k, :8].to(torch.float64) @ oh).to(torch.int64)
        return out.to(torch.int32)
    for k in range(wps):
        c_u = slot_columns(cu[:, -1, 32 * k:32 * (k + 1)].reshape(Bn, GROUP))
        idx = torch.where(c_u >= 0, c_u, 128)  # column 128: no slot
        if prod == 0:
            out += torch.nn.functional.one_hot(idx[:, :8], 129)[..., :128]
            continue
        acc = torch.zeros((Bn, 8, 129), dtype=torch.int64, device=dev)
        acc.scatter_add_(2, idx[:, None, :].expand(Bn, 8, GROUP),
                         big[:, k, :8].to(torch.int64))
        out += acc[..., :128]
    return out.to(torch.int32)


def depparts(cu: torch.Tensor, big: torch.Tensor, ohc0: torch.Tensor,
             mode: str) -> torch.Tensor:
    """Kernel P1's wrapper.

    cu (B, T, WPS*32, 128) int32, big (B, WPS, M, 4096) int8 with M >= 8,
    ohc0 (B, 4096, 128) int8; mode one of ALL_MODES.  Returns (B, 8, 128)
    int32: step t = T-1's output.  A CPU tensor takes depparts_plain; a
    CUDA tensor runs every step of the grid in the kernel (counted in
    `depparts.launches`) or raises.
    """
    if mode not in _ROUTES:
        raise ValueError(f"depparts: mode must be one of {ALL_MODES}")
    if cu.device.type == "cpu":
        return depparts_plain(cu, big, ohc0, mode)
    return _depparts_slots(cu, big, ohc0, mode)[:, -1]


def _depparts_slots(cu, big, ohc0, mode: str) -> torch.Tensor:
    """One call of csrc/prof_depparts.cu: every step's output, (B, T, 8,
    128) int32, slot t holding step t's (the product modes first stage
    their operands into scratch, then run the products)."""
    K.require_cuda("depparts", cu)
    Bn, Tn, R, _ = cu.shape
    wps = R // 32
    dev = cu.device
    for t in (big, ohc0):
        if t.device != dev or t.dtype != torch.int8 or not t.is_contiguous():
            raise ValueError("depparts: big and ohc0 must be contiguous int8 "
                             "tensors on cu's device")
    if cu.shape != (Bn, Tn, 32 * wps, 128) or not 1 <= wps <= MAX_WPS or \
            big.shape[:2] != (Bn, wps) or big.shape[2] < 8 or \
            big.shape[3] != GROUP or ohc0.shape != (Bn, GROUP, 128) or \
            not 1 <= Bn <= 65535:
        raise ValueError(f"depparts: cu (B, T, WPS*32, 128), big (B, WPS, M, "
                         f"4096) with M >= 8, ohc0 (B, 4096, 128), "
                         f"B <= 65535, 1 <= WPS <= {MAX_WPS}")
    if any(t.data_ptr() % 16 for t in (cu, big, ohc0)):
        raise ValueError("depparts: operands must be 16-byte aligned")
    src, prod = _ROUTES[mode]
    scratch = torch.empty(_scratch_bytes(Bn, wps, src, prod),
                          dtype=torch.uint8, device=dev)
    out = torch.empty((Bn, Tn, 8, 128), dtype=torch.int32, device=dev)
    K.check(K.lib().fpng_depparts(
        cu.data_ptr(), big.data_ptr(), ohc0.data_ptr(), Bn, Tn, wps,
        big.shape[2], src, prod, scratch.data_ptr(), out.data_ptr(),
        K.stream_ptr(dev)), "fpng_depparts")
    depparts.launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _scratch_bytes(b: int, wps: int, src: int, prod: int) -> int:
    """The kernel's scratch size, from the library (asked once a shape)."""
    return K.lib().fpng_depparts_scratch(b, wps, src, prod)


depparts.launches = 0


def inputs(b: int = B, t: int = T, wps: int = WPS, m: int = M,
           seed: int = 0, device="cuda"):
    """The probe's operands, from a seed: cu in [0, 128), big any int8,
    ohc0 in {0, 1}."""
    rng = np.random.default_rng(seed)
    cu = rng.integers(0, 128, (b, t, wps * 32, 128)).astype(np.int32)
    big = rng.integers(-128, 127, (b, wps, m, GROUP)).astype(np.int8)
    ohc0 = rng.integers(0, 2, (b, GROUP, 128)).astype(np.int8)
    return tuple(torch.from_numpy(x).to(device) for x in (cu, big, ohc0))


def main(device="cuda") -> int:
    from .profile_kernels import chain

    mode = os.environ.get("MODE", "all")
    if torch.device(device).type == "cuda":
        print(torch.cuda.get_device_name(0))
    args = inputs(device=device)
    for m in (MODES if mode == "all" else [mode]):
        t = chain(lambda: depparts(*args, m))
        print(f"{m:8s}: {t * 1e3:7.3f}ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
