"""fpng_tpu_torch on the extreme shapes fpng_tpu's suite pins, on the CPU.

tests/test_fuzz_shapes.py pins the shapes where budget and overflow logic
breaks: dim 1, extreme aspect ratios, the stored-fallback boundary.  Here
each runs at 3 and 4 channels, in 1-pass and 2-pass, plus forced-stored at
1 x 8193 x 3, filled as that test fills them (random bytes, the top half
flat).  The port's PNG bytes must equal fpng_tpu.encode_batch's, and its
decode statuses and pixels fpng_tpu.decode_batch's; the tall shapes take
the PK=1 walk after a walk8 overflow, except at 24 bpp 1-pass, where walk8
holds them.  fpng_tpu's result is computed once per case for the module.
Tolerance zero.
"""

import functools

import numpy as np
import pytest

import fpng_tpu as F
import fpng_tpu_torch as T
from fpng_tpu_torch.models.decoder import decode_batch

SHAPES = [  # tests/test_fuzz_shapes.py's
    (1, 1), (1, 8193), (8193, 1), (2, 4097), (4096, 2), (3, 2731),
    (1, 257), (513, 1),
]
TALL = {(8193, 1), (4096, 2), (513, 1)}
CASES = [(h, w, ch, flags) for h, w in SHAPES for ch in (3, 4)
         for flags in (0, T.FPNG_ENCODE_SLOWER)] + \
    [(1, 8193, 3, T.FPNG_FORCE_UNCOMPRESSED)]


def shape_image(h, w, ch):
    """Random bytes with the top half flat, seeded by the shape."""
    img = np.random.default_rng([h, w, ch]).integers(0, 256, (h, w, ch),
                                                     dtype=np.uint8)
    img[:max(1, h // 2)] = img[0, 0]
    return img


@functools.lru_cache(maxsize=None)
def _reference(h, w, ch, flags):
    """fpng_tpu's (png, statuses, pixels) for the case."""
    png = F.encode_batch(shape_image(h, w, ch)[None], flags)[0]
    sts, outs = F.decode_batch([png], ch)
    return png, sts, outs


def _id(case):
    h, w, ch, flags = case
    return f"{h}x{w}x{ch}-f{flags}"


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_shape_png_matches_fpng_tpu(case):
    h, w, ch, flags = case
    png = T.encode_batch(shape_image(h, w, ch)[None], flags, device="cpu")[0]
    assert png == _reference(*case)[0]


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_shape_decode_matches_fpng_tpu(case, monkeypatch):
    h, w, ch, flags = case
    png, want_sts, want_outs = _reference(*case)
    monkeypatch.setattr(decode_batch, "paths",
                        {"walk8": 0, "pk1": 0, "chunked": 0})
    sts, outs = T.decode_batch([png], ch, device="cpu")
    assert sts == want_sts == [T.FPNG_DECODE_SUCCESS]
    assert np.array_equal(outs[0], want_outs[0])
    assert np.array_equal(outs[0], shape_image(h, w, ch))
    stored = (png[58 + 2] & 6) == 0
    assert stored == ((h, w) == (1, 1) or
                      flags == T.FPNG_FORCE_UNCOMPRESSED)
    if stored:
        want = {"walk8": 0, "pk1": 0, "chunked": 0}
    elif (h, w) in TALL and (ch, flags) != (3, 0):
        want = {"walk8": 0, "pk1": 1, "chunked": 0}
    else:
        want = {"walk8": 1, "pk1": 0, "chunked": 0}
    assert decode_batch.paths == want
