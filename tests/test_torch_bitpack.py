"""fpng_tpu_torch's bit packing against fpng_tpu's, on the CPU.

The plain deposit (scatter_bits, which deposit_bits runs for CPU tensors)
must equal the JAX scatter on every word, and the Pallas deposit kernel B10
(scatter_bits_tpu, interpret mode, zero_init) on decode-style record
streams with gaps and zero-width units.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpng_tpu.ops import bitpack as JB
from fpng_tpu_torch.ops import bitpack as TB


def test_word32_roundtrip():
    x = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**32 - 1], dtype=torch.int64)
    w = TB.to_word32(x)
    assert w.dtype == torch.int32
    assert np.array_equal(w.numpy().view(np.uint32), x.numpy())
    assert torch.equal(TB.from_word32(w), x)


@pytest.mark.parametrize("seed,n", [(0, 37), (1, 1024), (2, 5000),
                                    (3, 20000)])
def test_scatter_bits_matches_jax(seed, n):
    rng = np.random.default_rng(seed)
    B = 3
    nbits = rng.integers(0, 19, (B, n)).astype(np.int32)
    nbits[:, rng.integers(0, n, n // 4)] = 0
    nbits[:, : n // 8] = 1
    vals = (rng.integers(0, 1 << 31, (B, n)).astype(np.uint32)
            & ((1 << nbits.astype(np.uint32)) - 1))
    base = rng.integers(8, 1200, B).astype(np.int32)
    j_offs = JB.exclusive_offsets(jnp.asarray(nbits), jnp.asarray(base))
    t_offs = TB.exclusive_offsets(torch.from_numpy(nbits),
                                  torch.from_numpy(base))
    assert np.array_equal(np.asarray(j_offs), t_offs.numpy())
    total = t_offs[:, -1] + torch.from_numpy(nbits)[:, -1]
    # one word short of the stream end: the last words are dropped
    num_words = int((total.max() + 31) // 32) - 1
    want = np.asarray(JB.scatter_bits(jnp.asarray(vals), jnp.asarray(nbits),
                                      j_offs, num_words))
    got = TB.deposit_bits(torch.from_numpy(vals.view(np.int32)),
                          torch.from_numpy(nbits), t_offs, num_words)
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_deposit_matches_pallas_with_gaps():
    """Decode-style records: sorted slots with large gaps, zero-width
    duplicates and trailing sentinels; gap words read as zero."""
    rng = np.random.default_rng(7)
    B, n, total = 2, 6000, 50000
    outp = np.sort(rng.integers(0, total, (B, n)))
    lit = rng.random((B, n)) < 0.4
    sym = rng.integers(0, 256, (B, n))
    vals = np.where(lit, sym | 0x100, 0).astype(np.uint32)
    nbits = np.where(lit, 16, 0).astype(np.int32)
    for b in range(B):  # literal slots are distinct
        _, first = np.unique(outp[b], return_index=True)
        dup = np.ones(n, bool)
        dup[first] = False
        vals[b, dup] = 0
        nbits[b, dup] = 0
    offs = (outp * 16).astype(np.int32)
    nw = (16 * (total + 1)) // 32 + 2
    want = np.asarray(JB.scatter_bits_tpu(
        jnp.asarray(vals), jnp.asarray(nbits), jnp.asarray(offs), nw,
        interpret=True, zero_init=True))
    got = TB.deposit_bits(torch.from_numpy(vals.view(np.int32)),
                          torch.from_numpy(nbits), torch.from_numpy(offs), nw)
    assert np.array_equal(got.numpy().view(np.uint32), want)


# ---------------------------------------------------------------------------
# B5's tiling (csrc/deposit.cu scatter_packed16_kernel): a Python twin
# ---------------------------------------------------------------------------

P16R, P16L, P16THREADS = 32, 64, 256  # kP16R, kP16L, kP16Threads


def _b5_twin(meta, metb, n_slots):
    """scatter_packed16_kernel, tile by tile: the value words loaded along
    lanes (thread tid: lane tid % L, steps tid / L + 4i), the all-zero
    tile stop, slot words loaded only under a non-zero value, then each
    warp's lane-major runs (lane ln, its 32 steps on the warp's 32
    threads).  Returns the raster, the (b, step, lane) slot words read,
    the number of tiles stopped, and each run's store slots."""
    if meta.ndim == 2:
        meta, metb = meta[:, None], metb[:, None]
    B, S, NC = meta.shape
    raster = np.zeros((B, n_slots), np.int64)
    reads, stopped, runs = set(), 0, []
    tid = np.arange(P16THREADS)
    for b in range(B):
        for ty in range(-(-S // P16R)):
            for tx in range(-(-NC // P16L)):
                l0, s0 = tx * P16L, ty * P16R
                sv = np.zeros((P16L, P16R), np.int64)
                ss = np.zeros((P16L, P16R), np.int64)
                for i in range(P16R * P16L // P16THREADS):
                    l, s = tid % P16L, tid // P16L + i * (P16THREADS // P16L)
                    live = (l0 + l < NC) & (s0 + s < S)
                    sv[l[live], s[live]] = metb[b, s0 + s[live], l0 + l[live]]
                if not sv.any():
                    stopped += 1
                    continue
                for l, s in zip(*np.nonzero(sv)):
                    ss[l, s] = meta[b, s0 + s, l0 + l]
                    reads.add((b, s0 + s, l0 + l))
                for warp in range(P16THREADS // 32):
                    for ln in range(warp, P16L, P16THREADS // 32):
                        x = sv[ln] & 0xFFFFFFFF  # lanes 0..31: steps
                        slot = ss[ln]
                        go = (x != 0) & (slot >= 0)
                        lo, hi = x & 0xFFFF, x >> 16
                        w_lo = go & (lo != 0) & (slot < n_slots)
                        w_hi = go & (hi != 0) & (slot < n_slots - 1)
                        raster[b, slot[w_lo]] = lo[w_lo]
                        raster[b, slot[w_hi] + 1] = hi[w_hi]
                        runs.append(np.concatenate([slot[w_lo],
                                                    slot[w_hi] + 1]))
    return raster.astype(np.uint16).view(np.int16), reads, stopped, runs


def _lane_records(rng, B, S, NC, n_slots):
    """Records as the finalize writes them, (B, S, NC): each lane owns a
    run of the raster and its records fill rising slots - a literal
    record one or two slots, a match a gap (value 0) - until its step
    count, past which the rows are zero.  Lanes from 64 on take at most
    20 steps, so their tiles past row 32 hold only zeros."""
    meta = np.zeros((B, S, NC), np.int64)
    metb = np.zeros((B, S, NC), np.int64)
    for b in range(B):
        nst = rng.integers(0, S + 1, NC)
        nst[rng.random(NC) < 0.3] = min(S, 20)
        nst[64:] = np.minimum(nst[64:], 20)
        pos = np.sort(rng.integers(0, n_slots, NC))
        for lane in range(NC):
            p = pos[lane]
            for s in range(nst[lane]):
                kind = rng.integers(0, 3)
                v = rng.integers(0, 256, 2)
                meta[b, s, lane] = p
                if kind == 0:
                    p += rng.integers(1, 9)
                    continue
                metb[b, s, lane] = (0x100 | v[0]) | \
                    ((0x100 | v[1]) << 16 if kind == 2 else 0)
                p += kind
            pos[lane] = p
        # distinct slots: keep each slot's first writer only
        seen = set()
        for s in range(S):
            for lane in range(NC):
                v = metb[b, s, lane]
                cells = {meta[b, s, lane]} | ({meta[b, s, lane] + 1}
                                             if v >> 16 else set())
                if v and cells & seen:
                    metb[b, s, lane] = 0
                elif v:
                    seen |= cells
    return meta.astype(np.int32), metb.astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("B,S,NC,n_slots", [
    (2, 40, 70, 6000),    # S and NC not multiples of the 32 x 64 tile
    (1, 96, 130, 20000),  # walk8's k8 at most 96
    (1, 1, 200, 900),     # a (B, N) call: one step of N lanes
])
def test_scatter_packed16_tiles_match_plain(B, S, NC, n_slots):
    """The twin of B5's tiling equals scatter_packed16_plain on lane-major
    records, in the (B, S, NC) form and flattened, with negative slots, a
    high half at slot + 1 == n_slots, a record at n_slots and records with
    no high half; slot words are read only under non-zero values, and
    tiles past every lane's step count stop after their value loads."""
    rng = np.random.default_rng(S * NC)
    meta, metb = _lane_records(rng, B, S, NC, n_slots)
    # edge records: a negative slot, a high half just past the raster, a
    # record at the raster's end (every half dropped)
    for lane, slot, v in ((0, -3, 0x1017F | 0x1000000),
                          (1, n_slots - 1, 0x105 | (0x106 << 16)),
                          (2, n_slots, 0x107)):
        meta[0, 0, lane], metb[0, 0, lane] = slot, v
    got, reads, stopped, runs = _b5_twin(meta, metb, n_slots)
    want = TB.scatter_packed16_plain(torch.from_numpy(meta),
                                     torch.from_numpy(metb), n_slots)
    assert np.array_equal(got, want.numpy())
    assert {(b, s, ln) for b, s, ln in zip(*np.nonzero(metb))} == reads
    flat = TB.scatter_packed16(torch.from_numpy(meta.reshape(B, -1)),
                               torch.from_numpy(metb.reshape(B, -1)), n_slots)
    assert torch.equal(flat, want)
    assert torch.equal(TB.scatter_packed16(
        torch.from_numpy(meta), torch.from_numpy(metb), n_slots), want)
    assert got[0, n_slots - 1] == 0x105 and (got[0, :3] != 0x17F).all()
    if S > P16R:
        assert stopped > 0  # rows 32.. of lanes 64.. hold only zeros
    # a lane's run stores rising slots
    assert all((np.diff(np.sort(r)) >= 0).all() for r in runs)


def test_scatter_packed16_flat_call_twin():
    """A (B, N) call is one step of N lanes: the twin's tiles over
    ceil(N / 64) lane tiles equal the plain version."""
    rng = np.random.default_rng(5)
    B, n, n_slots = 3, 1000, 3000
    slots = np.sort(rng.choice(n_slots // 2 + 8, (B, n)), axis=1) * 2 - 4
    kind = rng.integers(0, 3, (B, n))
    v = rng.integers(0, 256, (B, n, 2))
    metb = np.where(kind > 0, 0x100 | v[..., 0], 0) | \
        np.where(kind == 2, (0x100 | v[..., 1]) << 16, 0)
    first = np.concatenate([np.ones((B, 1), bool),
                            slots[:, 1:] != slots[:, :-1]], axis=1)
    meta = slots.astype(np.int32)
    metb = np.where(first, metb, 0).astype(np.int32)
    got, reads, _, _ = _b5_twin(meta, metb, n_slots)
    want = TB.scatter_packed16_plain(torch.from_numpy(meta),
                                     torch.from_numpy(metb), n_slots)
    assert np.array_equal(got, want.numpy())
    assert len(reads) == int((metb != 0).sum())
