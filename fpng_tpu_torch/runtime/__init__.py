"""Native host runtime: C++ container/checksum/header-parse layer.

A copy of fpng_tpu's runtime.  Compiled on demand from native.cpp with g++
into a cached shared object under the repository's git-ignored
.build/fpng_tpu_torch/ (never into the package directory) and bound via
ctypes (no external binding dependencies).  Every entry point has a
pure-Python twin (container.py / golden.py) used as the semantics oracle
in tests and as the fallback when no compiler is available.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), ".build",
                         "fpng_tpu_torch")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> str | None:
    """Compile native.cpp into a content-hash-keyed .so (never committed).

    Keying the artifact name on the source hash makes rebuilds robust to
    git checkouts (which equalize mtimes) and guarantees a stale binary is
    never loaded for changed source.
    """
    try:
        with open(_SRC, "rb") as f:
            key = hashlib.sha256(f.read()).hexdigest()[:16]
    except OSError:
        return None
    so = os.path.join(BUILD_DIR, f"_native-{key}.so")
    if os.path.exists(so):
        return so
    tmp = so + f".tmp{os.getpid()}"
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp],
            check=True, capture_output=True)
        os.replace(tmp, so)
        return so
    except (OSError, subprocess.CalledProcessError):
        return None


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("FPNG_TPU_NO_NATIVE"):
            return None
        so = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.fp_crc32.restype = ctypes.c_uint32
        lib.fp_crc32.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                 ctypes.c_uint32]
        lib.fp_adler32.restype = ctypes.c_uint32
        lib.fp_adler32.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                   ctypes.c_uint32]
        lib.fp_get_info.restype = ctypes.c_int
        lib.fp_get_info.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                    ctypes.c_int] + [u32p] * 5
        lib.fp_parse_dyn_header.restype = ctypes.c_int
        lib.fp_parse_dyn_header.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, u32p,
            ctypes.POINTER(ctypes.c_int32)]
        lib.fp_assemble_batch.restype = None
        lib.fp_assemble_batch.argtypes = [
            u8p, ctypes.c_int64, i64p, i64p, u32p, u8p, i64p,
            ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int,
            ctypes.c_int64, u8p, ctypes.c_int64, i64p]
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.fp_build_tables_batch.restype = None
        lib.fp_build_tables_batch.argtypes = [
            u32p, ctypes.c_int64, ctypes.c_int, u32p, i32p,
            u8p, ctypes.c_int64, i32p, u32p, i32p]
        lib.fp_defilter.restype = ctypes.c_int
        lib.fp_defilter.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, u8p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def crc32(data: bytes, prev: int = 0) -> int:
    return _load().fp_crc32(data, len(data), prev)


def adler32(data: bytes, prev: int = 1) -> int:
    return _load().fp_adler32(data, len(data), prev)


def get_info_internal(data: bytes, check_crcs: bool = True):
    """(status, w, h, ch, idat_ofs, idat_len) - container.py parity."""
    v = [ctypes.c_uint32() for _ in range(5)]
    st = _load().fp_get_info(data, len(data), int(check_crcs),
                             *[ctypes.byref(x) for x in v])
    return (st,) + tuple(x.value for x in v)


def parse_dyn_header(src: bytes, num_chans: int):
    """(packed_lut uint32[4096], p0_bits) or None (=> NOT_FPNG)."""
    lut = np.zeros(4096, np.uint32)
    p0 = ctypes.c_int32()
    st = _load().fp_parse_dyn_header(
        src, len(src), num_chans,
        lut.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.byref(p0))
    if st != 0:
        return None
    return lut, int(p0.value)


_PREFIX_STRIDE = 640  # > worst-case dynamic header (316 syms x 14 bits)


def build_tables_batch(hists: np.ndarray, num_chans: int):
    """Batched 2-pass table construction + header emit (C++).

    hists: (B, 288) uint32 token histograms (EOB count forced inside).
    Returns (codes (B,288) u32, sizes (B,288) i32, prefixes list[bytes],
    pend_vals (B,) u32, pend_ns (B,) i32) - byte-exact with the Python
    huffman.build_tables / emit_dynamic_block_header pipeline.
    """
    lib = _load()
    B = hists.shape[0]
    hists = np.ascontiguousarray(hists, np.uint32)
    codes = np.zeros((B, 288), np.uint32)
    sizes = np.zeros((B, 288), np.int32)
    pref = np.zeros((B, _PREFIX_STRIDE), np.uint8)
    plens = np.zeros(B, np.int32)
    pv = np.zeros(B, np.uint32)
    pn = np.zeros(B, np.int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.fp_build_tables_batch(
        hists.ctypes.data_as(u32p), B, num_chans,
        codes.ctypes.data_as(u32p), sizes.ctypes.data_as(i32p),
        pref.ctypes.data_as(u8p), _PREFIX_STRIDE,
        plens.ctypes.data_as(i32p), pv.ctypes.data_as(u32p),
        pn.ctypes.data_as(i32p))
    prefixes = [pref[b, :plens[b]].tobytes() for b in range(B)]
    return codes, sizes, prefixes, pv, pn


def assemble_batch(words: np.ndarray, total_bits: np.ndarray,
                   last_tok: np.ndarray, adler: np.ndarray,
                   prefixes: list[bytes], w: int, h: int, num_chans: int,
                   budget: int) -> list[bytes | None]:
    """Container assembly for a whole batch; None => stored fallback."""
    lib = _load()
    B, num_words = words.shape
    words = np.ascontiguousarray(words, np.uint32)
    tb = np.ascontiguousarray(total_bits, np.int64)
    lt = np.ascontiguousarray(last_tok, np.int64)
    ad = np.ascontiguousarray(adler, np.uint32)
    pdata = b"".join(prefixes)
    pofs = np.zeros(B + 1, np.int64)
    np.cumsum([len(p) for p in prefixes], out=pofs[1:])
    out_stride = 58 + budget + 16
    out = np.zeros((B, out_stride), np.uint8)
    out_lens = np.zeros(B, np.int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.fp_assemble_batch(
        words.ctypes.data_as(u8p), num_words,
        tb.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lt.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ad.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.cast(ctypes.c_char_p(pdata), u8p),
        pofs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        B, w, h, num_chans, budget,
        out.ctypes.data_as(u8p), out_stride,
        out_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return [out[b, :out_lens[b]].tobytes() if out_lens[b] else None
            for b in range(B)]


def defilter(raw: np.ndarray, fb: int) -> np.ndarray | None:
    """Native general PNG defilter: (h, 1+bpl) uint8 -> (h, bpl).

    Returns None on an invalid filter byte (caller raises).  The scalar
    Sub/Average/Paeth chains match pvpngreader.cpp:1047-1152.
    """
    lib = _load()
    h, bpl1 = raw.shape
    bpl = bpl1 - 1
    raw = np.ascontiguousarray(raw, np.uint8)
    out = np.zeros((h, bpl), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    rc = lib.fp_defilter(raw.ctypes.data_as(u8p), h, bpl, fb,
                         out.ctypes.data_as(u8p))
    return out if rc == 0 else None
