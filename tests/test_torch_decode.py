"""fpng_tpu_torch's chunked decode against fpng_tpu's, on the CPU.

decode_kernel must give the same (imgs, ok, overflow) as
fpng_tpu.ops.specdec.decode_kernel on the same packed streams (tolerance
zero: bytes and flags), and decode_batch the same statuses and pixels as
fpng_tpu.golden.decode_memory, corrupted streams included.
"""

import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fpng_tpu as F
import fpng_tpu_torch as T
from fpng_tpu import constants as C
from fpng_tpu import golden
from fpng_tpu.ops import specdec as JS
from fpng_tpu_torch.models.decoder import _parse_one, decode_batch
from fpng_tpu_torch.ops import specdec as TS
from tests.conftest import make_test_image


def _short_code_image(h=200, w=256):
    """Bytes in {0, 1}: 2-pass codes near 1.8 bits/token, so the chunked
    walk's 768-step bound overflows and the host decoder takes over."""
    rng = np.random.default_rng(0)
    return rng.integers(0, 2, (h, w, 3)).astype(np.uint8)


def _pack(pngs):
    metas = [_parse_one(p) for p in pngs]
    _, w, h, ch, *_ = metas[0]
    nb = 64
    while nb < max(len(m[4]) for m in metas):
        nb *= 2
    stream = np.zeros((len(pngs), nb), np.uint8)
    luts = np.zeros((len(pngs), 4096), np.uint32)
    p0 = np.zeros(len(pngs), np.int32)
    zl = np.zeros(len(pngs), np.int32)
    for j, (_, _, _, _, src, p, zlen, lut) in enumerate(metas):
        assert lut is not None
        stream[j, :len(src)] = np.frombuffer(src, np.uint8)
        luts[j] = TS.pack_lut(lut)
        p0[j], zl[j] = p, zlen
    return (h, w, ch, nb), stream, luts, p0, zl


@pytest.mark.parametrize("case", ["one_pass_3ch", "two_pass_4ch",
                                  "overflow"])
def test_decode_kernel_matches_jax(case):
    rng = np.random.default_rng(17)
    if case == "one_pass_3ch":
        from fpng_tpu.train import synthetic_corpus

        tiles = list(synthetic_corpus(3, size=40))
        imgs = [tiles[0][:13, :37], tiles[5][:13, :37], tiles[9][:13, :37]]
        pngs = F.encode_batch(np.stack(imgs), 0)
    elif case == "two_pass_4ch":
        imgs = [make_test_image(rng, 9, 22, 4, k) for k in ("mixed", "flat")]
        pngs = F.encode_batch(np.stack(imgs), F.FPNG_ENCODE_SLOWER)
    else:
        imgs = [_short_code_image()]
        pngs = [golden.encode_image_to_memory(imgs[0], 256, 200, 3,
                                              F.FPNG_ENCODE_SLOWER)]
    (h, w, ch, nb), stream, luts, p0, zl = _pack(pngs)
    s_bits, n_chunks, max_steps = TS.plan_chunks(nb)
    assert (s_bits, n_chunks, max_steps) == JS.plan_chunks(nb)
    kw = dict(h=h, w=w, c=ch, n_chunks=n_chunks, chunk_bits=s_bits,
              max_steps=max_steps)
    j_imgs, j_ok, j_ovf = (np.asarray(a) for a in JS.decode_kernel(
        jnp.asarray(stream), jnp.asarray(luts), jnp.asarray(p0),
        jnp.asarray(zl), **kw))
    t_imgs, t_ok, t_ovf = (a.numpy() for a in TS.decode_kernel(
        torch.from_numpy(stream), torch.from_numpy(luts.astype(np.int64)),
        torch.from_numpy(p0), torch.from_numpy(zl), **kw))
    assert np.array_equal(t_ok, j_ok) and np.array_equal(t_ovf, j_ovf)
    assert np.array_equal(t_imgs, j_imgs)
    assert t_ovf.any() == (case == "overflow")
    for img, ok, im in zip(imgs, t_ok, t_imgs):
        assert not ok or np.array_equal(im, img)


def test_overflow_hands_off_to_host_and_counts(monkeypatch):
    """The host hand-off comes only from the chunked tier, which takes the
    rasters past the walk gate: with the gate refusing, the stream that
    overflows the chunked walk decodes on the host."""
    from fpng_tpu_torch.models import decoder as TD

    monkeypatch.setattr(TD, "fits", lambda h, bpl: False)
    img = _short_code_image()
    png = golden.encode_image_to_memory(img, 256, 200, 3,
                                        F.FPNG_ENCODE_SLOWER)
    small = make_test_image(np.random.default_rng(2), 16, 16, 3, "mixed")
    pngs = [png] + T.encode_batch(small[None], 0, device="cpu")
    h0, d0 = decode_batch.host_handoffs, decode_batch.device_images
    sts, outs = T.decode_batch(pngs, 3, device="cpu")
    assert sts == [0, 0]
    assert np.array_equal(outs[0], img) and np.array_equal(outs[1], small)
    assert decode_batch.host_handoffs == h0 + 1
    assert decode_batch.device_images == d0 + 1


def test_mixed_batch():
    rng = np.random.default_rng(4)
    a = make_test_image(rng, 9, 9, 3, "mixed")
    b = make_test_image(rng, 5, 40, 4, "flat")
    pngs = [
        T.encode_batch(a[None], 0, device="cpu")[0],
        golden.encode_image_to_memory(b, 40, 5, 4, F.FPNG_ENCODE_SLOWER),
        T.encode_batch(a[None], F.FPNG_FORCE_UNCOMPRESSED, device="cpu")[0],
        b"not a png",
    ]
    sts, outs = T.decode_batch(pngs, 4, device="cpu")
    assert sts[:3] == [0, 0, 0]
    assert np.array_equal(outs[0][..., :3], a)
    assert (outs[0][..., 3] == 255).all()
    assert np.array_equal(outs[1], b)
    assert np.array_equal(outs[2][..., :3], a)
    assert sts[3] == C.FPNG_DECODE_FAILED_NOT_PNG and outs[3] is None
    assert T.decode_batch(pngs, 2, device="cpu")[0] == \
        [C.FPNG_DECODE_INVALID_ARG] * 4


def test_stage_spans_time_the_decode_without_changing_it(monkeypatch):
    from fpng_tpu_torch.train import synthetic_corpus

    a = np.ascontiguousarray(list(synthetic_corpus(3, size=32))[0][:21, :13])
    pngs = [T.encode_batch(a[None], 0, device="cpu")[0],
            T.encode_batch(a[None], F.FPNG_FORCE_UNCOMPRESSED,
                           device="cpu")[0]]
    want = T.decode_batch(pngs, 3, device="cpu")
    monkeypatch.setattr(decode_batch, "spans", {})
    got = T.decode_batch(pngs, 3, device="cpu")
    assert got[0] == want[0] == [0, 0]
    assert all(np.array_equal(g, w) for g, w in zip(got[1], want[1]))
    spans = decode_batch.spans
    assert set(spans) == {"parse", "host_stored", "pack", "h2d", "device",
                          "d2h", "finish"}
    assert all(v >= 0 for v in spans.values())


@pytest.fixture(scope="module")
def fuzz_pngs():
    rng = np.random.default_rng(23)
    imgs = [(rng.normal(120, 30, (24, 31, 3)).clip(0, 255)).astype(np.uint8),
            np.full((20, 20, 3), 7, np.uint8),
            make_test_image(rng, 12, 40, 3, "mixed")]
    return [T.encode_batch(i[None], 0, device="cpu")[0] for i in imgs]


def _assert_like_golden(datas, sts, outs):
    for data, st, out in zip(datas, sts, outs):
        g_st, g_out, *_ = golden.decode_memory(data, 3)
        assert st == g_st
        if g_st == 0:
            assert np.array_equal(out, g_out)


def test_byte_corruption_matches_golden(fuzz_pngs, monkeypatch):
    monkeypatch.setenv("FPNG_TPU_DISABLE_DECODE_CRC32_CHECKS", "1")
    rng = np.random.default_rng(29)
    bad = []
    for png in fuzz_pngs:
        arr = np.frombuffer(png, np.uint8)
        for _ in range(20):
            b = arr.copy()
            n = int(rng.integers(1, 6))
            pos = rng.integers(0, len(b), n)
            b[pos] ^= rng.integers(1, 256, n).astype(np.uint8)
            bad.append(b.tobytes())
    sts, outs = T.decode_batch(bad, 3, device="cpu")
    _assert_like_golden(bad, sts, outs)
    assert 0 < sum(s == 0 for s in sts) < len(bad)


def test_truncation_and_payload_bitflips_match_golden(fuzz_pngs):
    png = fuzz_pngs[0]
    rng = np.random.default_rng(31)
    cuts = [png[:k] for k in (0, 1, 8, 33, 45, 57, 58, 59, len(png) - 5)]
    flips = []
    for bitpos in rng.integers(58 * 8, (len(png) - 16) * 8, size=30):
        b = bytearray(png)
        b[bitpos // 8] ^= 1 << (bitpos % 8)
        flips.append(bytes(b))
    datas = cuts[1:] + flips  # b"" is INVALID_ARG for golden, handled apart
    sts, outs = T.decode_batch(datas, 3, device="cpu")
    _assert_like_golden(datas, sts, outs)
    assert T.fpng_decode_memory(cuts[0], 3, device="cpu")[0] == \
        C.FPNG_DECODE_INVALID_ARG


def test_header_claiming_too_many_bytes_is_rejected(fuzz_pngs, monkeypatch):
    """A raster larger than any stream of the file's length can code is
    NOT_FPNG without a device pass, as golden finds by decoding."""
    monkeypatch.setenv("FPNG_TPU_DISABLE_DECODE_CRC32_CHECKS", "1")
    bad = bytearray(fuzz_pngs[1])
    assert bad[58 + 2] & 6  # a dynamic block, not stored
    bad[16:24] = struct.pack(">II", 3000, 3000)
    st = T.fpng_decode_memory(bytes(bad), 3, device="cpu")[0]
    assert st == C.FPNG_DECODE_NOT_FPNG == golden.decode_memory(bytes(bad),
                                                                3)[0]


@pytest.mark.parametrize("w,h,past_bound", [(512, 256, True),
                                            (40, 40, False)])
def test_relabelled_header_status_matches_fpng_tpu_and_golden(w, h,
                                                              past_bound):
    """A valid 20 x 20 file whose IHDR is rewritten to w x h with a valid
    CRC.  Past the bound h * (1 + w * ch) > 258 * 8 * zlib_len the port
    rejects it without a device pass (models/decoder.py); within it the
    device decode rejects it.  The port, fpng_tpu.decode_batch and both
    golden decoders give the same status."""
    from fpng_tpu_torch import golden as TG

    png = bytearray(T.encode_batch(np.full((1, 20, 20, 3), 7, np.uint8), 0,
                                   device="cpu")[0])
    assert png[58 + 2] & 6  # a dynamic block, not stored
    zlib_len = int.from_bytes(png[50:54], "big")
    assert (h * (1 + w * 3) > 258 * 8 * zlib_len) == past_bound
    png[16:24] = struct.pack(">II", w, h)
    png[29:33] = struct.pack(">I", zlib.crc32(bytes(png[12:29])))
    png = bytes(png)
    assert T.fpng_get_info(png)[:3] == (0, w, h)
    d0, paths = decode_batch.device_images, dict(decode_batch.paths)
    st = T.decode_batch([png], 3, device="cpu")[0]
    assert (dict(decode_batch.paths) == paths) == past_bound
    assert decode_batch.device_images == d0
    want = F.decode_batch([png], 3)[0]
    assert st == want == [C.FPNG_DECODE_NOT_FPNG]
    assert TG.decode_memory(png, 3)[0] == golden.decode_memory(png, 3)[0] \
        == C.FPNG_DECODE_NOT_FPNG
