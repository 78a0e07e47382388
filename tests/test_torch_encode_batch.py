"""fpng_tpu_torch.encode_batch against fpng_tpu.encode_batch, on the CPU.

24 bpp 1-pass with the device IDAT CRC: the PNG bytes must be identical,
including the stored fallback (noise images) and FPNG_FORCE_UNCOMPRESSED,
and the port's decoder must round-trip them.
"""

import numpy as np
import pytest

import fpng_tpu as F
import fpng_tpu_torch as T
from fpng_tpu import constants as C
from tests.conftest import make_test_image

KINDS = ("mixed", "flat", "noise")


def _batch(h, w, seed):
    rng = np.random.default_rng(seed)
    return np.stack([make_test_image(rng, h, w, 3, k) for k in KINDS])


@pytest.mark.parametrize("h,w", [(1, 1), (2, 2), (13, 17), (33, 7),
                                 (3, 300), (127, 31)])
def test_encode_batch_bytes_match(h, w):
    """Byte-identical PNGs (noise images take the stored fallback) that
    round-trip through the port's decoder."""
    imgs = _batch(h, w, 31 * h + w)
    want = F.encode_batch(imgs, 0)
    got = T.encode_batch(imgs, 0, device="cpu")
    assert got == want
    sts, outs = T.decode_batch(got, 3, device="cpu")
    assert sts == [0, 0, 0]
    assert all(np.array_equal(o, i) for o, i in zip(outs, imgs))


def test_stored_fallback_and_forced_uncompressed():
    rng = np.random.default_rng(9)
    noise = rng.integers(0, 256, (2, 48, 48, 3), dtype=np.uint8)
    got = T.encode_batch(noise, 0, device="cpu")
    assert got == F.encode_batch(noise, 0)
    assert all((p[58 + 2] & 6) == 0 for p in got)  # stored blocks
    imgs = _batch(20, 30, 4)
    forced = T.encode_batch(imgs, C.FPNG_FORCE_UNCOMPRESSED, device="cpu")
    assert forced == F.encode_batch(imgs, C.FPNG_FORCE_UNCOMPRESSED)
    sts, outs = T.decode_batch(forced + got, 3, device="cpu")
    assert sts == [0] * 5
    assert all(np.array_equal(o, i)
               for o, i in zip(outs, list(imgs) + list(noise)))


def test_single_image_entry_point_matches():
    img = _batch(21, 34, 8)[0]
    got = T.fpng_encode_image_to_memory(img, 34, 21, 3, device="cpu")
    assert got == F.fpng_encode_image_to_memory(img, 34, 21, 3)
