"""fpng_tpu_torch.parallel.mesh against fpng_tpu.parallel.mesh on the CPU.

tests/test_mesh.py's six cases, each with the port on an 8-shard "cpu"
mesh and fpng_tpu on its virtual 8-device CPU mesh, fed the same seeded
inputs, tolerance zero; plus encode_kernel's fused histogram, make_mesh
without a card, and the sharded decode's path through the dispatch.
"""

import jax
import numpy as np
import pytest
import torch

import fpng_tpu as F
import fpng_tpu_torch as T
from fpng_tpu import golden
from fpng_tpu.models import encoder as FE
from fpng_tpu.parallel import mesh as FM
from fpng_tpu.tables import get_one_pass_tables
from fpng_tpu_torch import graft_entry
from fpng_tpu_torch.models import decoder as TD
from fpng_tpu_torch.models import encoder as TE
from fpng_tpu_torch.parallel import mesh as TM
from fpng_tpu_torch.tables import one_pass_state


@pytest.fixture(scope="module")
def meshes():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return TM.make_mesh(["cpu"] * 8), FM.make_mesh(jax.devices()[:8])


@pytest.mark.parametrize("c,flags", [
    (3, 0), (4, 0), (3, F.FPNG_ENCODE_SLOWER), (3, F.FPNG_FORCE_UNCOMPRESSED)])
def test_sharded_encode_matches_fpng_tpu_and_golden(meshes, c, flags):
    tm, fm = meshes
    rng = np.random.default_rng(20 + c)
    imgs = rng.integers(0, 256, (8, 16, 24, c), dtype=np.uint8)
    imgs[:, 4:9] = 5
    got = TM.encode_batch_sharded(tm, imgs, flags)
    assert got == FM.encode_batch_sharded(fm, imgs, flags)
    assert got == T.encode_batch(imgs, flags, device="cpu")
    for b in range(8):
        assert got[b] == golden.encode_image_to_memory(imgs[b], 24, 16, c,
                                                       flags), b


def test_training_step_matches_fpng_tpu(meshes):
    tm, fm = meshes
    rng = np.random.default_rng(21)
    imgs = rng.integers(0, 4, (8, 8, 8, 3), dtype=np.uint8)
    got = TM.training_step(tm, imgs, 3)
    assert got.dtype == torch.int64 and tuple(got.shape) == (288,)
    got = got.numpy()
    assert np.array_equal(got, np.asarray(FM.training_step(fm, imgs, 3)))
    want = np.zeros(288, np.int64)
    for b in range(8):
        h = golden.histogram_tokens(golden.tokenize_image(
            golden.filter_image(imgs[b]), 3))
        h[256] = 0  # histogram_tokens forces EOB=1; the device's does not
        want += h
    assert np.array_equal(got, want)
    assert torch.equal(TM.training_step(tm, TM.shard_batch(tm, imgs), 3),
                       torch.from_numpy(got))


def test_full_step_sharded_matches_fpng_tpu(meshes):
    tm, fm = meshes
    rng = np.random.default_rng(22)
    imgs = rng.integers(0, 256, (16, 8, 16, 3), dtype=np.uint8)
    imgs[:, 2:4] = 9
    got = TM.full_step_sharded(tm, imgs, 3)
    want = FM.full_step_sharded(fm, imgs, 3)
    words, total_bits, adler, ghist = (t.numpy() for t in got)
    assert words.shape == (16, np.asarray(want[0]).shape[1])
    assert np.array_equal(words.view(np.uint32),
                          np.asarray(want[0]).astype(np.uint32))
    for a, b in zip((total_bits, adler, ghist), want[1:]):
        assert np.array_equal(a.astype(np.int64),
                              np.asarray(b).astype(np.int64))
    assert np.array_equal(ghist, TM.training_step(tm, imgs, 3).numpy())


def test_sharded_decode_roundtrip_matches_fpng_tpu(meshes):
    tm, fm = meshes
    rng = np.random.default_rng(23)
    imgs = rng.integers(0, 8, (8, 12, 20, 3), dtype=np.uint8)
    imgs[:, 3:7] = 2
    pngs = F.encode_batch(imgs)
    dec, ok = TM.decode_batch_sharded(tm, pngs, 12, 20, 3)
    jdec, jok = FM.decode_batch_sharded(fm, pngs, 12, 20, 3)
    assert ok.dtype == np.bool_ and ok.all()
    assert np.array_equal(ok, np.asarray(jok))
    assert np.array_equal(dec, np.asarray(jdec))
    assert np.array_equal(dec, imgs)


def test_dryrun_multichip_cpu(meshes):
    graft_entry.dryrun_multichip(8, device="cpu")


def test_indivisible_batch_rejected(meshes):
    tm, _ = meshes
    imgs = np.zeros((3, 4, 4, 3), np.uint8)
    with pytest.raises(ValueError, match="not divisible"):
        TM.encode_batch_sharded(tm, imgs, 0)
    with pytest.raises(ValueError, match="not divisible"):
        TM.shard_batch(tm, imgs)
    with pytest.raises(ValueError, match="not divisible"):
        TM.decode_batch_sharded(tm, T.encode_batch(imgs, device="cpu"),
                                4, 4, 3)


def test_sharded_decode_rejects_stored_and_mixed_files(meshes):
    tm, _ = meshes
    imgs = np.random.default_rng(24).integers(0, 8, (8, 6, 6, 3),
                                              dtype=np.uint8)
    stored = T.encode_batch(imgs, F.FPNG_FORCE_UNCOMPRESSED, device="cpu")
    with pytest.raises(ValueError, match="uniform dynamic"):
        TM.decode_batch_sharded(tm, stored, 6, 6, 3)
    pngs = T.encode_batch(imgs, device="cpu")
    with pytest.raises(ValueError, match="uniform dynamic"):
        TM.decode_batch_sharded(tm, pngs, 6, 7, 3)


@pytest.mark.parametrize("c,cost_check", [(3, False), (4, True), (4, False)])
def test_encode_kernel_hist_matches_fpng_tpu(c, cost_check):
    """encode_kernel(want_hist=True): all five results against fpng_tpu's
    encode_kernel on the same images and 1-pass tables; want_hist=False
    gives a (B, 1) zero histogram, as fpng_tpu's does."""
    B, H, W = 3, 10, 13
    rng = np.random.default_rng(30 + c)
    imgs = rng.integers(0, 256, (B, H, W, c), dtype=np.uint8)
    imgs[:, 3:6] = rng.integers(0, 256, c, dtype=np.uint8)
    imgs[:, :, 7:9] = 200
    prefix, acc, nacc, codes1, sizes1 = get_one_pass_tables(c)
    num_words = max(TE._budget(H, W, c) // 4 + 4, 8)
    st = one_pass_state(c, "cpu")

    def col(v):
        return torch.full((B,), v, dtype=torch.int32)

    hists = {}
    for want_hist in (True, False):
        got = TE.encode_kernel(
            torch.from_numpy(imgs), st.codes.expand(B, -1),
            st.sizes.expand(B, -1), col(len(st.prefix) * 8), col(st.acc),
            col(st.nacc), num_chans=c, cost_check=cost_check,
            want_hist=want_hist, num_words=num_words)
        want = FE.encode_kernel(
            imgs, np.broadcast_to(codes1.astype(np.uint32), (B, 288)),
            np.broadcast_to(sizes1.astype(np.int32), (B, 288)),
            np.full(B, len(prefix) * 8, np.int32),
            np.full(B, acc, np.uint32), np.full(B, nacc, np.int32),
            num_chans=c, cost_check=cost_check, want_hist=want_hist,
            num_words=num_words)
        assert len(got) == len(want) == 5
        assert np.array_equal(got[0].numpy().view(np.uint32),
                              np.asarray(want[0]).astype(np.uint32))
        for a, b in zip(got[1:], want[1:]):
            assert a.shape == np.asarray(b).shape
            assert np.array_equal(a.numpy().astype(np.int64),
                                  np.asarray(b).astype(np.int64))
        assert got[4].dtype == torch.int64
        hists[want_hist] = got[4]
    if not cost_check:  # no demoted pixels: the 2-pass histogram's tokens
        assert torch.equal(hists[True],
                           TE.hist_kernel(torch.from_numpy(imgs),
                                          num_chans=c))


def test_make_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.make_mesh()
    with pytest.raises(RuntimeError, match="need 2 CUDA devices"):
        graft_entry.dryrun_multichip(2, device="cuda")
    mesh = TM.make_mesh(["cpu", "cpu"], axis="batch")
    assert mesh.size == 2 and mesh.axis == "batch"
    assert mesh.devices == (torch.device("cpu"),) * 2


def test_graft_entry_step_matches_fpng_tpu():
    import __graft_entry__ as G

    fn, args = graft_entry.entry(device="cpu")
    jfn, jargs = G.entry()
    got, want = fn(*args), jfn(*jargs)
    assert np.array_equal(args[0].numpy(), np.asarray(jargs[0]))
    assert np.array_equal(got[0].numpy().view(np.uint32),
                          np.asarray(want[0]).astype(np.uint32))
    for a, b in zip(got[1:], want[1:]):
        assert np.array_equal(a.numpy().astype(np.int64),
                              np.asarray(b).astype(np.int64))


@pytest.mark.parametrize("gate", ["walk8", "chunked"])
def test_sharded_decode_goes_through_the_dispatch(monkeypatch, gate):
    """Each shard takes dispatch_kernel's path: walk8 within the walk gate,
    the chunked decode when the gate refuses (as past 2^27 slots)."""
    tm = TM.make_mesh(["cpu"] * 4)
    rng = np.random.default_rng(25)
    imgs = rng.integers(0, 8, (8, 12, 20, 3), dtype=np.uint8)
    imgs[:, 3:7] = 2
    pngs = T.encode_batch(imgs, device="cpu")
    if gate == "chunked":
        monkeypatch.setattr(TD, "fits", lambda h, bpl: False)
    calls = []
    dispatch = TM.dispatch_kernel
    monkeypatch.setattr(TM, "dispatch_kernel",
                        lambda *a, **k: calls.append(a[0].shape) or
                        dispatch(*a, **k))
    monkeypatch.setattr(TD.decode_batch, "paths",
                        {"walk8": 0, "pk1": 0, "chunked": 0})
    dec, ok = TM.decode_batch_sharded(tm, pngs, 12, 20, 3)
    assert ok.all() and np.array_equal(dec, imgs)
    assert calls == [torch.Size([2, calls[0][1]])] * 4
    want = {"walk8": 0, "pk1": 0, "chunked": 0}
    want[gate] = 4
    assert TD.decode_batch.paths == want
