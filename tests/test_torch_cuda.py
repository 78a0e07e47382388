"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA device and skips without one (the CPU tests
hold the plain versions against fpng_tpu).  The file imports no JAX, so it
also runs where JAX is not installed, without tests/conftest.py:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import zlib

import numpy as np
import pytest
import torch

import fpng_tpu_torch as T
from fpng_tpu_torch.models.encoder import _budget, _num_words, build_desc
from fpng_tpu_torch.ops.assemble import idat_crc_words, raw_idat_prefix
from fpng_tpu_torch.ops.bitpack import deposit_bits, scatter_bits
from fpng_tpu_torch.ops.checksum import crc_chunks, crc_chunks_plain
from fpng_tpu_torch.ops.encfuse import encode_bits_fused, encode_bits_plain
from fpng_tpu_torch.tables import one_pass_state

pytestmark = pytest.mark.usefixtures("cuda_device")


@pytest.fixture
def rng():
    return np.random.default_rng(0xC0DA)


def make_test_image(rng, h, w, c, kind):
    """Noise, with flat bands and columns unless kind == "noise"."""
    img = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    if kind != "noise" and h >= 4 and w >= 4:
        img[h // 4:h // 2, :] = rng.integers(0, 256, c, dtype=np.uint8)
        img[:, w // 4:w // 3] = rng.integers(0, 256, c, dtype=np.uint8)
    if kind == "flat":
        img[h // 2:] = img[:1, :1]
    return img


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _desc(imgs, device):
    B = imgs.shape[0]
    st = one_pass_state(3, device)
    desc, tbl, *_ = build_desc(
        torch.from_numpy(imgs).to(device), st.codes.expand(B, -1),
        st.sizes.expand(B, -1),
        torch.full((B,), st.acc, device=device),
        torch.full((B,), st.nacc, device=device), num_chans=3,
        cost_check=False)
    base = torch.full((B,), len(st.prefix) * 8, dtype=torch.int32,
                      device=device)
    return desc, tbl, base


@pytest.mark.parametrize("shape,nw_cut", [
    ((2, 13, 29), 0), ((3, 64, 64), 0), ((1, 1, 1), 0), ((2, 127, 31), 0),
    ((2, 100, 200), 0), ((2, 100, 200), 3000)])
def test_encfuse_matches_plain(rng, shape, nw_cut):
    B, H, W = shape
    imgs = np.stack([make_test_image(rng, H, W, 3, k)
                     for k in ("mixed", "flat", "noise")[:B]])
    dev = torch.device("cuda")
    desc, tbl, base = _desc(imgs, dev)
    nw = nw_cut or _num_words(_budget(H, W, 3))  # nw_cut drops words
    n0 = encode_bits_fused.launches
    got = encode_bits_fused(desc, tbl, base, nw)
    torch.cuda.synchronize()
    assert encode_bits_fused.launches == n0 + 1
    want = encode_bits_plain(desc.cpu(), tbl.cpu(), base.cpu(), nw)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("K", [1, 2, 5])
def test_crc_chunks_matches_plain_and_zlib(K):
    rng = np.random.default_rng(K)
    B, NW = 4, K * 1024
    words = rng.integers(0, 2**32, (B, NW), np.uint64).astype(np.uint32)
    lo = np.array([0, 5, 61, 4097 % (4 * NW)], np.int64)
    hi = np.array([4 * NW, 4 * NW - 3, 4 * NW // 2 + 1, 4 * NW - 18])
    wt = torch.from_numpy(words.view(np.int32)).cuda()
    got = crc_chunks(wt, torch.from_numpy(lo).cuda(),
                     torch.from_numpy(hi).cuda())
    want = crc_chunks_plain(wt.cpu(), torch.from_numpy(lo),
                            torch.from_numpy(hi))
    assert torch.equal(got.cpu(), want)

    prefixes = [b"\x78\x01" + bytes(rng.integers(0, 256, 40, np.uint8))
                for _ in range(B)]
    tb = np.maximum(hi, 60)
    adler = rng.integers(0, 2**32, B, np.uint64).astype(np.int64)
    crc = idat_crc_words(
        wt, torch.from_numpy(tb * 8).cuda(), torch.from_numpy(adler).cuda(),
        torch.tensor([len(p) for p in prefixes]).cuda(),
        torch.from_numpy(raw_idat_prefix(prefixes).astype(np.int64)).cuda())
    crc = crc.cpu().numpy()
    for b in range(B):
        raw = bytearray(words[b].tobytes()[:tb[b]])
        raw[:len(prefixes[b])] = prefixes[b]
        msg = b"IDAT" + bytes(raw) + int(adler[b]).to_bytes(4, "big")
        assert int(crc[b]) == zlib.crc32(msg), b


@pytest.mark.parametrize("n,total,nw_cut", [
    (6000, 50000, 0), (70000, 30000, 0), (5000, 40000, 500)])
def test_deposit_matches_scatter(n, total, nw_cut):
    rng = np.random.default_rng(n)
    B = 3
    # decode-style records: sorted slots, literals at distinct slots,
    # zero-width records at repeated ones
    step = rng.random((B, n)) < 0.3
    outp = np.minimum(np.cumsum(step, axis=1), total)
    lit = step & (rng.random((B, n)) < 0.8)
    vals = np.where(lit, rng.integers(0, 256, (B, n)) | 0x100, 0)
    nbits = np.where(lit, 16, 0)
    offs = outp * 16
    nw = nw_cut or (16 * (total + 1)) // 32 + 2
    args = [torch.from_numpy(a.astype(np.int32)) for a in (vals, nbits, offs)]
    n0 = deposit_bits.launches
    got = deposit_bits(*[a.cuda() for a in args], nw)
    assert deposit_bits.launches == n0 + 1
    assert torch.equal(got.cpu(), scatter_bits(*args, nw))


def test_kernel_wrappers_reject_wrong_dtype():
    x = torch.zeros((1, 8), dtype=torch.int64, device="cuda")
    with pytest.raises(ValueError):
        deposit_bits(x, x, x, 4)


def test_roundtrip_on_card_matches_cpu(rng):
    imgs = np.stack([make_test_image(rng, 40, 100, 3, k)
                     for k in ("mixed", "flat", "noise")])
    gpu = T.encode_batch(imgs, 0, device="cuda")
    cpu = T.encode_batch(imgs, 0, device="cpu")
    assert gpu == cpu
    sts, outs = T.decode_batch(gpu, 3, device="cuda")
    assert sts == [0, 0, 0]
    assert all(np.array_equal(o, i) for o, i in zip(outs, imgs))
