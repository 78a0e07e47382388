"""fpng_tpu_torch's streaming API against fpng_tpu's, on the CPU: the five
cases of tests/test_stream_api.py, byte for byte and pixel for pixel."""

import numpy as np

import fpng_tpu as F
import fpng_tpu_torch as T
from fpng_tpu import constants as C


def _batches(rng, n=3, B=2, h=24, w=31, c=3):
    out = []
    for k in range(n):
        img = rng.normal(120 + 10 * k, 14, (B, h, w, c)) \
            .clip(0, 255).astype(np.uint8)
        img[:, 5:9] = 40 + k  # flat band => matches
        out.append(img)
    return out


def _encode_both(batches, flags):
    got = list(T.encode_batch_stream(iter(batches), flags, device="cpu"))
    want = list(F.encode_batch_stream(iter(batches), flags))
    assert got == want
    assert got == [T.encode_batch(b, flags, device="cpu") for b in batches]
    return got


def test_encode_stream_matches_fpng_tpu_1pass():
    _encode_both(_batches(np.random.default_rng(21)), 0)


def test_encode_stream_matches_fpng_tpu_2pass():
    _encode_both(_batches(np.random.default_rng(22)), C.FPNG_ENCODE_SLOWER)


def test_encode_stream_stored():
    _encode_both(_batches(np.random.default_rng(23), n=2),
                 C.FPNG_FORCE_UNCOMPRESSED)


def test_decode_stream_matches_fpng_tpu():
    rng = np.random.default_rng(24)
    batches = _batches(rng)
    pngs = [F.encode_batch(b, 0) for b in batches]
    # corrupt one file in the middle batch: per-file status must localize
    pngs[1][0] = pngs[1][0][:40] + b"\xff" + pngs[1][0][41:]
    got = list(T.decode_batch_stream(iter(pngs), 3, device="cpu"))
    want = list(F.decode_batch_stream(iter(pngs), 3))
    assert len(got) == len(want) == len(batches)
    for (sts, outs), (wsts, wouts), k in zip(got, want, range(len(pngs))):
        assert sts == wsts == T.decode_batch(pngs[k], 3, device="cpu")[0]
        for o, wo in zip(outs, wouts):
            assert (o is None) == (wo is None)
            if o is not None:
                assert np.array_equal(o, wo)
    assert got[1][0][0] != C.FPNG_DECODE_SUCCESS
    assert got[1][0][1] == C.FPNG_DECODE_SUCCESS


def test_stream_empty_and_single():
    assert list(T.encode_batch_stream(iter([]), 0, device="cpu")) == []
    assert list(T.decode_batch_stream(iter([]), 3, device="cpu")) == []
    b = _batches(np.random.default_rng(25), n=1)[0]
    assert list(T.encode_batch_stream(iter([b]), 0, device="cpu")) == \
        list(F.encode_batch_stream(iter([b]), 0))
