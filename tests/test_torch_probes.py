"""The probes P1 and P2 of fpng_tpu_torch.tools against fpng_tpu's Pallas
kernels (tools/prof_depparts.py, tools/prof_int8mxu.py) in interpret mode,
on the CPU, at small sizes: exact match.

Neither JAX probe can be imported for its kernel alone: prof_int8mxu runs
its probe only under __main__, so it is loaded by file path; prof_depparts
runs its probe at import, at B = 32, so make_kernel's source is taken out
with ast and run with small bindings (GROUP stays 4096: the body slices 32
rows of 128).  The pallas_calls have the probes' own grids and index maps,
without the TPU memory spaces.
"""

import ast
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from fpng_tpu_torch.tools import prof_depparts as TP1
from fpng_tpu_torch.tools import prof_int8mxu as TP2
from fpng_tpu_torch.tools.profile_kernels import chain, force1

_TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")


def _depparts_make_kernel(wps):
    src = open(os.path.join(_TOOLS, "prof_depparts.py")).read()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef) and n.name == "make_kernel")
    ns = {"jax": jax, "jnp": jnp, "GROUP": 4096, "WPS": wps}
    exec(compile(ast.Module([fn], []), "prof_depparts.py", "exec"), ns)
    return ns["make_kernel"]


def _jax_depparts(cu, big, ohc0, mode):
    Bn, Tn, R, _ = cu.shape
    wps, M = R // 32, big.shape[2]
    f = pl.pallas_call(
        _depparts_make_kernel(wps)(mode), grid=(Bn, Tn),
        in_specs=[pl.BlockSpec((1, 1, wps * 32, 128),
                               lambda b, t: (b, t, 0, 0)),
                  pl.BlockSpec((1, wps, M, 4096), lambda b, t: (b, 0, 0, 0)),
                  pl.BlockSpec((1, 4096, 128), lambda b, t: (b, 0, 0))],
        out_specs=pl.BlockSpec((1, 8, 128), lambda b, t: (b, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((Bn, 8, 128), jnp.int32),
        interpret=True)
    return np.asarray(f(jnp.asarray(cu), jnp.asarray(big), jnp.asarray(ohc0)))


@pytest.fixture(scope="module")
def p1_inputs():
    """B = T = WPS = 2, M = 8; cu spans negative words and the high bits
    that the slot arithmetic's shift drops."""
    rng = np.random.default_rng(7)
    cu = rng.integers(0, 128, (2, 2, 64, 128)).astype(np.int32)
    cu[:, :, ::5] = rng.integers(-(1 << 31), 1 << 31, (2, 2, 13, 128),
                                 dtype=np.int64).astype(np.int32)
    big = rng.integers(-128, 128, (2, 2, 8, 4096)).astype(np.int8)
    ohc0 = rng.integers(0, 2, (2, 4096, 128)).astype(np.int8)
    return cu, big, ohc0


@pytest.mark.parametrize("mode", TP1.ALL_MODES)
def test_depparts_plain_matches_pallas(p1_inputs, mode):
    want = _jax_depparts(*p1_inputs, mode)
    got = TP1.depparts(*(torch.from_numpy(a) for a in p1_inputs), mode)
    assert got.dtype == torch.int32 and got.shape == (2, 8, 128)
    assert np.array_equal(got.numpy(), want)


def _jax_int8mxu(a, b, dtype, reps, T):
    spec = importlib.util.spec_from_file_location(
        "_prof_int8mxu", os.path.join(_TOOLS, "prof_int8mxu.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    K = a.shape[1]
    f = pl.pallas_call(
        mod.make_kernel(dtype, K, reps), grid=(T,),
        in_specs=[pl.BlockSpec((128, K), lambda t: (0, 0)),
                  pl.BlockSpec((K, 128), lambda t: (0, 0))],
        out_specs=pl.BlockSpec((128, 128), lambda t: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((128, 128), jnp.int32),
        interpret=True)
    return np.asarray(f(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_int8_mxu_plain_matches_pallas(dtype):
    """K = 256, reps = 3, T = 2; a reaches past 256, so the int8 cast
    wraps and the bf16 cast rounds."""
    rng = np.random.default_rng(3)
    a = rng.integers(0, 1000, (128, 256)).astype(np.int32)
    b = rng.integers(0, 2, (256, 128)).astype(np.int32)
    want = _jax_int8mxu(a, b, getattr(jnp, dtype), reps=3, T=2)
    got = TP2.int8_mxu(torch.from_numpy(a), torch.from_numpy(b),
                       dtype=getattr(torch, dtype), reps=3, T=2)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def test_chain_times_cpu_calls():
    x = torch.arange(10)
    assert force1((x * 2, None)) == 18
    assert chain(lambda: x + 1, K=3) > 0


# ---------------------------------------------------------------------------
# P2's operand maps (csrc/prof_int8mxu.cu): a numpy twin
# ---------------------------------------------------------------------------

STEPS, STEP_B, LBO, SBO = 4, 4096, 128, 256  # kSteps, kStepB, descriptor


def _bf16_bits(x):
    """int32 -> float32 -> bfloat16 (nearest even), as uint16 bit patterns."""
    return torch.from_numpy(np.ascontiguousarray(x, np.int32)).float() \
        .bfloat16().view(torch.int16).numpy().view(np.uint16)


def _p2_geometry(K, bf16):
    kk, ab = (16, 32) if bf16 else (32, 16)
    nkp = -(-(K // kk) // STEPS) * STEPS
    return kk, ab, nkp


def _p2_stage(a, b, bf16):
    """int8mxu_stage_kernel: the scratch bytes, chunk by chunk (16 bytes a
    chunk), as the kernel computes each chunk's source elements."""
    K = a.shape[1]
    kk, ab, nkp = _p2_geometry(K, bf16)
    halves = ab // 16
    nb, na = nkp * (STEP_B // 16), 2 * nkp * halves * 128
    out = np.zeros((nb + na, 16), np.uint8)
    ap = np.zeros((128, nkp * kk + 16), np.int64)
    ap[:, :K] = a
    bp = np.zeros((nkp * kk + 16, 128), np.int64)
    bp[:K] = b
    ci = np.arange(nb)
    ks, off = ci // (STEP_B // 16), (ci % (STEP_B // 16)) * 16
    n, kh = (off >> 8) * 8 + ((off >> 4) & 7), (off >> 7) & 1
    if bf16:
        k = ks[:, None] * kk + kh[:, None] * 8 + np.arange(8)
        out[:nb] = _bf16_bits(bp[k, n[:, None]]).view(np.uint8) \
            .reshape(nb, 16)
    else:
        k = ks[:, None] * kk + kh[:, None] * 16 + np.arange(16)
        out[:nb] = (bp[k, n[:, None]] & 0xFF).astype(np.uint8)
    c = np.arange(na)
    tid, hf = c % 128, c // 128 % halves
    ks, mt = c // (128 * halves) % nkp, c // (128 * halves * nkp)
    g, q = (tid & 31) >> 2, tid & 3
    row0 = mt * 64 + (tid >> 5) * 16 + g
    for u in range(4):
        if bf16:
            i, e = (4 * hf + u) >> 1, u & 1
            row = row0 + 8 * (i & 1)
            k = ks * kk + 8 * (i >> 1) + 2 * q + e
            out[nb + c, 4 * u:4 * u + 4] = ap[row, k].astype(np.int32) \
                .view(np.uint8).reshape(-1, 4)
        else:
            row = row0 + 8 * (u & 1)
            k = ks[:, None] * kk + 16 * (u >> 1) + 4 * q[:, None] + \
                np.arange(4)
            out[nb + c, 4 * u:4 * u + 4] = (ap[row[:, None], k] & 0xFF) \
                .astype(np.uint8)
    return out.reshape(-1), nkp


def _p2_read_b(scratch, nkp, bf16):
    """B (K', 128) as the wgmma descriptor reads it: element (n, kb) of
    k-step ks at ks * 4096 + (n / 8) * SBO + (kb / 16) * LBO + (n % 8) * 16
    + kb % 16 (no swizzle, K-major)."""
    kb = np.arange(32)
    n = np.arange(128)
    addr = (np.arange(nkp)[:, None, None] * STEP_B +
            (n[None, :, None] >> 3) * SBO + (kb[None, None] >> 4) * LBO +
            (n[None, :, None] & 7) * 16 + (kb[None, None] & 15))
    byts = scratch[addr]  # (nkp, 128 n, 32 kb)
    if bf16:
        bits = byts.reshape(nkp, 128, 16, 2).copy().view(np.uint16)[..., 0]
        vals = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16) \
            .double().numpy()
        return vals.transpose(0, 2, 1).reshape(nkp * 16, 128)
    return byts.view(np.int8).astype(np.float64).transpose(0, 2, 1) \
        .reshape(nkp * 32, 128)


def _p2_read_a(scratch, nkp, bf16, r):
    """A (128, K') of rep r as the register fragments hold it: thread tid
    (warp w, g, q) of m tile mt, register i = its 16-byte chunk's word i
    (int8) or int words 2i, 2i + 1 (bf16, half i // 2), row 16w + g +
    8 (i % 2), k 16 (i // 2) + 4q + e (int8) or 8 (i // 2) + 2q + e
    (bf16); int8 registers add r byte-wise (__vadd4), bf16 ones round
    a + r."""
    kk, ab = (16, 32) if bf16 else (32, 16)
    halves = ab // 16
    base = nkp * STEP_B
    A = np.zeros((128, nkp * kk), np.float64)
    for mt in range(2):
        for ks in range(nkp):
            for tid in range(128):
                w, g, q = tid >> 5, (tid & 31) >> 2, tid & 3
                words = []
                for hf in range(halves):
                    o = base + (((mt * nkp + ks) * halves + hf) * 128 +
                                tid) * 16
                    words.append(scratch[o:o + 16])
                chunk = np.concatenate(words)
                for i in range(4):
                    row = mt * 64 + 16 * w + g + 8 * (i % 2)
                    if bf16:
                        v = chunk[8 * i:8 * i + 8].view(np.int32)
                        for e in range(2):
                            A[row, ks * 16 + 8 * (i // 2) + 2 * q + e] = \
                                int(v[e]) + r
                    else:
                        byts = (chunk[4 * i:4 * i + 4].astype(np.int64) +
                                r) & 0xFF
                        for e in range(4):
                            A[row, ks * 32 + 16 * (i // 2) + 4 * q + e] = \
                                byts[e] - 256 * (byts[e] >= 128)
    if bf16:
        A = torch.from_numpy(A).float().bfloat16().double().numpy()
    return A


@pytest.mark.parametrize("K,reps", [(32, 3), (96, 2), (256, 1)])
@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_int8_mxu_operand_maps_give_the_product(dtype, K, reps):
    """The staged scratch (B K-major in the descriptor's no-swizzle layout,
    A in register-fragment order, K padded to whole 4-step stages), read
    back through the descriptor and the fragment maps, with the kernel's
    groups of two reps (an odd count padded by a zero A), gives
    int8_mxu_plain's product exactly."""
    bf16 = dtype == "bfloat16"
    rng = np.random.default_rng(K + reps)
    a = rng.integers(0, 300 if bf16 else 1000, (128, K)).astype(np.int32)
    b = rng.integers(-1 if bf16 else -300, 2 if bf16 else 300,
                     (K, 128)).astype(np.int32)
    scratch, nkp = _p2_stage(a, b, bf16)
    Bq = _p2_read_b(scratch, nkp, bf16)
    acc = np.zeros((128, 128), np.float64)
    for r in range(0, reps, 2):
        for rr in (r, r + 1):
            Ar = _p2_read_a(scratch, nkp, bf16, rr) if rr < reps else \
                np.zeros((128, Bq.shape[0]))
            acc += Ar @ Bq
    got = (acc.astype(np.int64) & 0xFFFFFFFF).astype(np.uint32) \
        .view(np.int32) if not bf16 else acc.astype(np.int32)
    want = TP2.int8_mxu_plain(torch.from_numpy(a), torch.from_numpy(b),
                              dtype=getattr(torch, dtype), reps=reps)
    assert np.array_equal(got, want.numpy())
    assert scratch.size == _p2_scratch_bytes(K, bf16)


def _p2_scratch_bytes(K, bf16):
    """fpng_int8mxu_scratch(K, bf16)."""
    _, ab, nkp = _p2_geometry(K, bf16)
    return nkp * STEP_B + 2 * nkp * 128 * ab
