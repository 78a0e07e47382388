"""Build and bind the port's CUDA kernels (fpng_tpu_torch/csrc/*.cu).

The sources are compiled at first use - one `nvcc -c` per .cu file, all
started together, then one link - into one shared library with a plain C
interface, keyed on a hash of the sources and the flags, and bound with
ctypes.  Nothing here runs at import: `import fpng_tpu_torch` needs neither
a card nor a CUDA toolchain.

Every C entry point launches on the stream it is given (the caller passes
`torch.cuda.current_stream().cuda_stream`), allocates nothing, does not
synchronise, and returns `cudaGetLastError()`; `check` raises on non-zero.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), ".build", "fpng_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # desc, tbl, base_bits, B, N, num_words, words, total, last_tok,
    # block_offsets, stream
    "fpng_encfuse": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P],
    # words, total_bits, adler, meta, table, shifts, B, NW, crc, stream
    "fpng_idat_crc": [_P, _P, _P, _P, _P, _P, _I, _I, _P, _P],
    # vals, offsets, shift, B, N, num_words (int64), words, stream
    "fpng_deposit": [_P, _P, _I, _I, _I, ctypes.c_longlong, _P, _P],
    # words, nw, lut, p0, zl8, B, NC, ST, abort_on_overflow, ent, ex0,
    # ex1, nst, ovf, posr, raw0, raw1, ctl, info (host), stream
    "fpng_walk8": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                   _P, _P, _P, _P, _P, _P],
    # posr, raw0, raw1, ST, nst, e_fin, out0, B, NC, k8, h, bpl, c, meta,
    # metb, chk, stream
    "fpng_finalize8": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _P, _P, _P, _P],
    # meta, metb, B, S, NC, n_slots, raster, stream
    "fpng_scatter_packed16": [_P, _P, _I, _I, _I, _I, _P, _P],
    # raster, B, h, w, c, rows, strip, bands, scratch, out, stream
    "fpng_expand": [_P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    # deltas, len_sym, len_extra, cand, tbl, B, HW, out, stream
    "fpng_demote": [_P, _P, _P, _P, _P, _I, _I, _P, _P],
    # cu, big, ohc0, B, T, WPS, M, src, prod, scratch, out, stream
    "fpng_depparts": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    # B, WPS, src, prod -> scratch bytes (restype long long)
    "fpng_depparts_scratch": [_I, _I, _I, _I],
    # a, b, K, reps, T, bf16, scratch, out, stream
    "fpng_int8mxu": [_P, _P, _I, _I, _I, _I, _P, _P, _P],
    # K, bf16 -> scratch bytes (restype long long)
    "fpng_int8mxu_scratch": [_I, _I],
}
_RESTYPES = {"fpng_int8mxu_scratch": ctypes.c_longlong,
             "fpng_depparts_scratch": ctypes.c_longlong}

_lib = None


def _sources() -> list[str]:
    return sorted(os.path.join(_CSRC, f) for f in os.listdir(_CSRC)
                  if f.endswith((".cu", ".cuh")))


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path() -> str:
    """Path of the library built from the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in _sources():
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libfpng_kernels-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernel library if its hash-keyed .so is missing."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    nvcc = nvcc_path()
    objs, procs = [], []
    for src in (s for s in _sources() if s.endswith(".cu")):
        obj = f"{tmp}.{os.path.basename(src)}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errors = []
    for obj, p in zip(objs, procs):
        _, err = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc failed ({p.returncode}) for {obj}:\n{err}")
    if not errors:
        res = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            errors.append(f"nvcc link failed ({res.returncode}):\n"
                          f"{res.stderr}")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if errors:
        raise RuntimeError("\n".join(errors))
    os.replace(tmp, so)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = _RESTYPES.get(name, ctypes.c_int)
        _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(name: str, *tensors, dtype=torch.int32) -> None:
    """Validate kernel inputs: one CUDA device, contiguous, `dtype`."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or not t.is_contiguous() or t.dtype != dtype:
            raise ValueError(
                f"{name}: inputs must be contiguous {dtype} tensors on one "
                f"CUDA device (got {t.dtype} on {t.device})")
