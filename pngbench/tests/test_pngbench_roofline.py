"""The roofline byte counts against a hand count on a tiny batch."""

import pytest

from pngbench import pngref, roofline
import numpy as np


def test_decode_and_encode_bytes_by_hand():
    rng = np.random.default_rng(0)
    imgs = [np.zeros((4, 5, 3), np.uint8),
            rng.integers(0, 256, (4, 5, 4), dtype=np.uint8)]
    files = [pngref.write(i) for i in imgs]
    rec = [(pngref.idat_bytes(p), *i.shape, True) for p, i in zip(files, imgs)]
    z0, z1 = (len(pngref.chunks(p)[1][1]) for p in files)
    assert roofline.decode_bytes(rec) == z0 + 60 + z1 + 80
    assert roofline.encode_bytes(rec) == z0 + 60 + z1 + 80
    rec[1] = rec[1][:4] + (False,)  # decoded by the host: no card bytes
    assert roofline.decode_bytes(rec) == z0 + 60
    assert roofline.encode_bytes(rec) == z0 + 60 + z1 + 80


def test_share():
    card = roofline.DEFAULT_CARD
    assert roofline.share(3.35e12, 2.0, card) == pytest.approx(50.0)
    assert roofline.share(0, 1.0, card) is None
    assert roofline.share(10, 0.0, card) is None
