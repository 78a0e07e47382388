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
