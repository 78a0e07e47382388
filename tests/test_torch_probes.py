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


# ---------------------------------------------------------------------------
# P1's operand maps (csrc/prof_depparts.cu): a numpy twin
# ---------------------------------------------------------------------------

KKB, STEPB1, FRAGA, CHUNK_STEPS = 32, 1024, 2048, 8  # kKB, kStepB, ...


def _p1_geometry(bf16):
    el = 2 if bf16 else 1
    return el, KKB // el, 4096 // (KKB // el)  # el, kk, nks


def _to_bytes(vals, bf16):
    """int8 values as the kernel stores them: bytes, or bf16 bit patterns
    (little-endian byte pairs)."""
    if bf16:
        return _bf16_bits(vals).view(np.uint8).reshape(*vals.shape[:-1], -1)
    return vals.astype(np.int8).view(np.uint8)


def _from_bytes(byts, bf16):
    """The inverse, as float64 values (bf16 through torch's bfloat16)."""
    if bf16:
        bits = np.ascontiguousarray(byts).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).double().numpy()
    return np.ascontiguousarray(byts).view(np.int8).astype(np.float64)


def _p1_stage_b(big, bf16):
    """depparts_stage_b_kernel: the B scratch, piece by piece (16 bytes:
    row r, half kh of k-step ks of walk group wg, walk 4 wg + n8)."""
    Bn, wps = big.shape[:2]
    el, kk, nks = _p1_geometry(bf16)
    NG = -(-wps // 4)
    p = np.arange(Bn * nks * NG * 64)
    r, kh, n8, rest = p % 8, p // 8 % 2, p // 16 % 4, p // 64
    wg, ks, b = rest % NG, rest // NG % nks, rest // NG // nks
    walk = 4 * wg + n8
    g = ks[:, None] * kk + kh[:, None] * 16 // el + np.arange(16 // el)
    vals = big[b[:, None], np.minimum(walk, wps - 1)[:, None], r[:, None], g]
    vals = np.where((walk < wps)[:, None], vals, 0)
    return _to_bytes(vals, bf16).reshape(-1), NG


def _p1_stage_a(ohc0, bf16):
    """depparts_stage_a_kernel: ohc0^T in wgmma's register-A fragments,
    computed as each 64-unit block computes them from its tile."""
    Bn = ohc0.shape[0]
    el, kk, nks = _p1_geometry(bf16)
    out = np.zeros(Bn * 2 * nks * FRAGA, np.uint8)
    f = np.arange(64 // kk * 256)
    ft, mt, ksl = f % 128, f // 128 % 2, f // 256
    lane = ft & 31
    g, q = lane >> 2, lane & 3
    row0 = mt * 64 + (ft >> 5) * 16 + g
    for b in range(Bn):
        for u0 in range(0, 4096, 64):
            tile = ohc0[b, u0:u0 + 64]  # [unit][column]
            regs = []
            for i in range(4):
                j = row0 + 8 * (i & 1)
                if bf16:
                    k = ksl * kk + 8 * (i >> 1) + 2 * q
                    v = np.stack([tile[k, j], tile[k + 1, j]], axis=1)
                else:
                    k = ksl * kk + 16 * (i >> 1) + 4 * q
                    v = np.stack([tile[k + e, j] for e in range(4)], axis=1)
                regs.append(_to_bytes(v, bf16))
            ks = u0 // kk + ksl
            at = (((b * 2 + mt) * nks + ks) * FRAGA + ft * 16)[:, None] + \
                np.arange(16)
            out[at] = np.concatenate(regs, axis=1)
    return out


def _p1_read_a_frags(sa, b, mt, bf16):
    """A (64, 4096) of half mt as the register fragments hold it: thread
    tid (warp w, g, q), register i = word i of its 16 bytes, row 16w + g +
    8 (i % 2), units 16 (i // 2) + 4q + e (int8) or 8 (i // 2) + 2q + e
    (bf16) of the k-step."""
    el, kk, nks = _p1_geometry(bf16)
    A = np.zeros((64, 4096))
    tid = np.arange(128)
    w, g, q = tid >> 5, (tid & 31) >> 2, tid & 3
    for ks in range(nks):
        chunk = sa[((b * 2 + mt) * nks + ks) * FRAGA + tid[:, None] * 16 +
                   np.arange(16)]
        for i in range(4):
            vals = _from_bytes(chunk[:, 4 * i:4 * i + 4], bf16)
            row = 16 * w + g + 8 * (i % 2)
            base = 16 * (i // 2) + 4 * q if not bf16 else 8 * (i // 2) + 2 * q
            for e in range(vals.shape[1]):
                A[row, ks * kk + base + e] = vals[:, e]
    return A


def _p1_read_desc(buf, start, bf16, n_rows, lbo=128, sbo=256):
    """One k-step (32 bytes of K) of an operand with n_rows rows, as a
    no-swizzle K-major descriptor reads it, (K, n_rows): element (n, kb)
    at start + (n / 8) * sbo + (kb / 16) * lbo + (n % 8) * 16 + kb % 16."""
    n = np.arange(n_rows)[:, None]
    kb = np.arange(32)[None]
    byts = buf[start + (n >> 3) * sbo + (kb >> 4) * lbo + (n & 7) * 16 +
               (kb & 15)]
    return _from_bytes(byts, bf16).T  # (k, n)


def _onehot_at(j, u, bf16):
    """onehot_at: the byte of one-hot element (column j, unit u) in a
    chunk tile."""
    kb = u * (2 if bf16 else 1)
    return (kb >> 5) * 4096 + (j >> 6) * 2048 + ((j >> 3) & 7) * 256 + \
        ((kb >> 4) & 1) * 128 + (j & 7) * 16 + (kb & 15)


def _acc_map(n_cols):
    """The m64nN accumulator fragments of a warpgroup: (thread, register)
    -> (row, column): d[4 jb + e] of thread (w, g, q) is row 16w + g
    (+ 8 for e >= 2), column 8 jb + 2q + (e & 1)."""
    tid = np.arange(128)[:, None]
    reg = np.arange(n_cols // 2)[None]
    jb, e = reg // 4, reg % 4
    w, g, q = tid >> 5, (tid & 31) >> 2, tid & 3
    return 16 * w + g + 8 * (e >> 1), 8 * jb + 2 * q + (e & 1)


def _p1_epilogue(D, half, fold):
    """The epilogue of one 64-row half: each thread's registers (the four
    walk blocks summed when fold) to (big's row i, output column j), as
    the kernels store them; returns the (8, 128) slab it writes and the
    count of writes to each word."""
    n_cols = D.shape[1]
    row, col = _acc_map(n_cols)
    d = D[row, col]  # (128 threads, n_cols / 2 registers)
    if fold:
        d = d[:, 0:4] + d[:, 4:8] + d[:, 8:12] + d[:, 12:16]
    tid = np.arange(128)[:, None]
    e = np.arange(4)[None]
    g, q = (tid & 31) >> 2, tid & 3
    j0 = half * 64 + (tid >> 5) * 16 + g
    i, j = 2 * q + (e & 1), j0 + 8 * (e >> 1)
    out = np.zeros((8, 128))
    hits = np.zeros((8, 128), np.int64)
    np.add.at(out, (i, j), d[:, :4])
    np.add.at(hits, (i, j), 1)
    return out, hits


def _p1_twin(cu, big, ohc0, mode):
    """The (B, T, 8, 128) output of csrc/prof_depparts.cu through the
    twin's maps."""
    src, prod = TP1._ROUTES[mode]
    Bn, Tn, R, _ = cu.shape
    wps = R // 32
    out = np.zeros((Bn, Tn, 8, 128), np.int64)
    if prod == 0:  # depparts_noprod_kernel
        tid = np.arange(256)[:, None]
        e = np.arange(4)[None]
        for b in range(Bn):
            for t in range(Tn):
                if src == 1:
                    res = wps * ohc0[b].reshape(-1)[tid * 4 + e]
                else:
                    res = np.zeros((256, 4), np.int64)
                    stride = 144
                    for k in range(wps):
                        tile = np.zeros(128 * stride, np.int64)
                        col = TP1.slot_columns(torch.from_numpy(
                            cu[b, t, 32 * k])).numpy()  # chunk c = 0
                        u = np.nonzero(col >= 0)[0]
                        tile[col[u] * stride + u] = 1
                        res += tile[(4 * (tid & 31) + e) * stride +
                                    (tid >> 5)]
                out[b, t] = res.reshape(8, 128)
        return out
    bf16 = prod == 2
    el, kk, nks = _p1_geometry(bf16)
    sb, NG = _p1_stage_b(big, bf16)
    if src == 1:
        sa = _p1_stage_a(ohc0, bf16)
        for b in range(Bn):
            for mt in range(2):
                A = _p1_read_a_frags(sa, b, mt, bf16)
                D = np.zeros((64, 32))
                for ks in range(nks):
                    for wg in range(NG):
                        Bk = _p1_read_desc(
                            sb, ((b * nks + ks) * NG + wg) * STEPB1, bf16, 32)
                        D += A[:, ks * kk:(ks + 1) * kk] @ Bk
                slab, hits = _p1_epilogue(D, mt, fold=True)
                assert (hits[:, mt * 64:(mt + 1) * 64] == 1).all()
                for t in range(Tn):  # every step issues the same products
                    out[b, t, :, mt * 64:(mt + 1) * 64] = \
                        slab[:, mt * 64:(mt + 1) * 64]
        return out
    kc = CHUNK_STEPS * kk
    tid = np.arange(kc)
    for b in range(Bn):
        for t in range(Tn):
            cub = cu[b, t].reshape(-1)
            tiles = np.zeros((2, 128 * 1024), np.uint8)
            old = [np.full(kc, -1), np.full(kc, -1)]
            D = np.zeros((2, 64, 8))
            for c in range(wps * (4096 // kc)):
                p = c & 1
                col = TP1.slot_columns(torch.from_numpy(
                    cub[c * kc:(c + 1) * kc].copy())).numpy()
                at = np.where(col >= 0, _onehot_at(col, tid, bf16), -1)
                prev = old[p]
                for a, one in ((prev, 0), (at, 1)):  # clear, then set
                    a = a[a >= 0]
                    tiles[p, a] = 0 if one == 0 else (0x80 if bf16 else 1)
                    if bf16:
                        tiles[p, a + 1] = 0 if one == 0 else 0x3F
                old[p] = at
                k = c // (4096 // kc)
                bp = np.zeros(2048, np.uint8)
                for pc in range(128):
                    ks = (c % (4096 // kc)) * CHUNK_STEPS + pc // 16
                    s0 = ((b * nks + ks) * NG + k // 4) * STEPB1 + \
                        (k % 4) * 256 + (pc % 16) * 16
                    bp[pc * 16:pc * 16 + 16] = sb[s0:s0 + 16]
                for half in range(2):
                    for ks in range(CHUNK_STEPS):
                        Ak = _p1_read_desc(tiles[p], ks * 4096 +
                                             half * 2048, bf16, 64).T
                        Bk = _p1_read_desc(bp, ks * 256, bf16, 8)
                        D[half] += Ak @ Bk
            for half in range(2):
                slab, hits = _p1_epilogue(D[half], half, fold=False)
                assert (hits[:, half * 64:(half + 1) * 64] == 1).all()
                out[b, t, :, half * 64:(half + 1) * 64] = \
                    slab[:, half * 64:(half + 1) * 64]
    return out


@pytest.mark.parametrize("wps", [1, 5])
@pytest.mark.parametrize("mode", TP1.ALL_MODES)
def test_depparts_operand_maps_give_the_product(mode, wps):
    """The staged B (big's rows K-major, four walks side by side in N),
    the ohc0 modes' A fragments, the cu modes' one-hot chunks (set, then
    cleared two chunks on), read back through the descriptor, fragment
    and accumulator maps, with the walk fold in N: every step's slot
    equals depparts_plain on that step, for every mode, at B = T = 2, M =
    9, with negative and high-bit slot words in cu."""
    rng = np.random.default_rng(11 * wps + len(mode))
    cu = rng.integers(0, 128, (2, 2, 32 * wps, 128)).astype(np.int32)
    cu[:, :, ::5] = rng.integers(-(1 << 31), 1 << 31, cu[:, :, ::5].shape,
                                 dtype=np.int64).astype(np.int32)
    big = rng.integers(-128, 128, (2, wps, 9, 4096)).astype(np.int8)
    ohc0 = rng.integers(0, 2, (2, 4096, 128)).astype(np.int8)
    got = _p1_twin(cu, big, ohc0, mode)
    for t in range(2):
        want = TP1.depparts_plain(torch.from_numpy(cu[:, t:t + 1]),
                                  torch.from_numpy(big),
                                  torch.from_numpy(ohc0), mode)
        assert np.array_equal(got[:, t], want.numpy()), t

