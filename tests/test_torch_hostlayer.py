"""fpng_tpu_torch's copy of the host layer against fpng_tpu's, on the CPU.

The port keeps its own copies of fpng_tpu's framework-free modules
(constants, bitio, huffman, container, golden, tables + _tables_data,
train, runtime/native.cpp, utils/pngreader, utils/pngcheck).  On the
same inputs they must give the same results; the port's native runtime
builds under .build/fpng_tpu_torch/, never inside a package directory.
"""

import os

import numpy as np
import pytest
import torch

import fpng_tpu as F
import fpng_tpu_torch as T
from fpng_tpu import constants as FC
from fpng_tpu import container as Fcontainer
from fpng_tpu import golden as Fgolden
from fpng_tpu import huffman as Fhuffman
from fpng_tpu import runtime as Fruntime
from fpng_tpu import tables as Ftables
from fpng_tpu import train as Ftrain
from fpng_tpu_torch import constants as TC
from fpng_tpu_torch import container as Tcontainer
from fpng_tpu_torch import golden as Tgolden
from fpng_tpu_torch import huffman as Thuffman
from fpng_tpu_torch import runtime as Truntime
from fpng_tpu_torch import tables as Ttables
from fpng_tpu_torch import train as Ttrain
from fpng_tpu.utils import pngcheck as Fpngcheck
from fpng_tpu.utils import pngreader as Fpngreader
from fpng_tpu_torch.utils import pngcheck as Tpngcheck
from fpng_tpu_torch.utils import pngreader as Tpngreader
from tests.conftest import make_test_image


def _same(a, b):
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("c", [3, 4])
def test_one_pass_tables_match(c):
    assert _same(Ttables.get_one_pass_tables(c), Ftables.get_one_pass_tables(c))


@pytest.mark.parametrize("c", [3, 4])
def test_one_pass_state_from_fpng_tpu_arrays(c):
    own = Ttables.one_pass_state(c, "cpu")
    ref = Ttables.one_pass_state(c, "cpu", Ftables.get_one_pass_tables(c))
    assert (own.prefix, own.acc, own.nacc) == (ref.prefix, ref.acc, ref.nacc)
    for a, b in zip(own[3:], ref[3:]):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_constants_match():
    names = [n for n in dir(FC) if n.isupper()]
    assert names == [n for n in dir(TC) if n.isupper()]
    for n in names:
        assert _same(getattr(TC, n), getattr(FC, n)), n


def test_synthetic_corpus_matches():
    got = list(Ttrain.synthetic_corpus(3, 256))
    want = list(Ftrain.synthetic_corpus(3, 256))
    assert len(got) == len(want) == 40
    assert all(_same(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("c", [3, 4])
def test_huffman_tables_match(c):
    rng = np.random.default_rng(c)
    freq = rng.integers(0, 5000, 288).astype(np.uint64)
    freq[rng.random(288) < 0.3] = 0
    a, b = Thuffman.build_tables(freq, c), Fhuffman.build_tables(freq, c)
    for f in ("lit_codes", "lit_sizes"):
        assert np.array_equal(getattr(a, f), getattr(b, f))


@pytest.fixture(scope="module")
def files():
    """1-pass, 2-pass and stored files, 3 and 4 channels, plus corrupted
    copies (byte flips anywhere in the file)."""
    rng = np.random.default_rng(41)
    out = []
    for c in (3, 4):
        for kind in ("mixed", "flat", "noise"):
            img = make_test_image(rng, 17, 23, c, kind)
            for flags in (0, FC.FPNG_ENCODE_SLOWER, FC.FPNG_FORCE_UNCOMPRESSED):
                out.append(Fgolden.encode_image_to_memory(img, 23, 17, c,
                                                          flags))
    bad = []
    for png in out[:8]:
        for _ in range(6):
            b = bytearray(png)
            for pos in rng.integers(0, len(b), int(rng.integers(1, 4))):
                b[pos] ^= int(rng.integers(1, 256))
            bad.append(bytes(b))
    return out, bad


def test_golden_encode_matches(files):
    rng = np.random.default_rng(41)
    for c in (3, 4):
        img = make_test_image(rng, 17, 23, c, "mixed")
        for flags in (0, FC.FPNG_ENCODE_SLOWER):
            assert Tgolden.encode_image_to_memory(img, 23, 17, c, flags) == \
                Fgolden.encode_image_to_memory(img, 23, 17, c, flags)


@pytest.mark.parametrize("which", ["encoded", "corrupted"])
@pytest.mark.parametrize("crc_checks", [True, False])
def test_golden_decode_matches(files, which, crc_checks, monkeypatch):
    if not crc_checks:
        monkeypatch.setenv("FPNG_TPU_DISABLE_DECODE_CRC32_CHECKS", "1")
    datas = files[0] if which == "encoded" else files[1]
    statuses = set()
    for data in datas:
        for desired in (3, 4):
            got = Tgolden.decode_memory(data, desired)
            want = Fgolden.decode_memory(data, desired)
            assert got[0] == want[0] and got[2:] == want[2:]
            assert (got[1] is None) == (want[1] is None)
            if got[1] is not None:
                assert np.array_equal(got[1], want[1])
            statuses.add(got[0])
    assert statuses == {0} if which == "encoded" else len(statuses) > 1


def test_container_matches(files):
    for png in files[0] + files[1]:
        for check in (True, False):
            assert Tcontainer.get_info_internal(png, check) == \
                Fcontainer.get_info_internal(png, check)
        assert Tcontainer.get_info(png) == Fcontainer.get_info(png)
        assert Tcontainer.crc32(png) == Fcontainer.crc32(png)
        assert Tcontainer.adler32(png) == Fcontainer.adler32(png)


def test_native_runtime_matches_and_builds_outside_the_packages(files):
    assert Truntime.available() and Fruntime.available()
    so = Truntime._build()
    assert os.path.dirname(so) == Truntime.BUILD_DIR
    assert Truntime.BUILD_DIR.endswith(os.path.join(".build",
                                                    "fpng_tpu_torch"))
    pkg = os.path.dirname(os.path.abspath(Truntime.__file__))
    assert not [f for f in os.listdir(pkg) if f.endswith(".so")]
    n_headers = 0
    for png in files[0] + files[1]:
        for check in (True, False):
            assert Truntime.get_info_internal(png, check) == \
                Fruntime.get_info_internal(png, check)
        st, w, h, ch, ofs, length = Truntime.get_info_internal(png, False)
        if st != 0:
            continue
        src = png[ofs + 8:]
        for c in (3, 4):
            got = Truntime.parse_dyn_header(src, c)
            want = Fruntime.parse_dyn_header(src, c)
            assert (got is None) == (want is None)
            if got is not None:
                n_headers += 1
                assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    assert n_headers > 0


def test_port_roundtrip_matches_fpng_tpu_bytes():
    rng = np.random.default_rng(5)
    img = make_test_image(rng, 12, 19, 3, "mixed")
    png = F.encode_batch(img[None], 0)[0]
    assert T.encode_batch(img[None], 0, device="cpu")[0] == png
    st, out, *_ = T.fpng_decode_memory(png, 3, device="cpu")
    assert st == 0 and np.array_equal(out, img)


def _load_both(data, desired):
    out = []
    for mod in (Tpngreader, Fpngreader):
        try:
            out.append(mod.load_png(data, desired))
        except mod.PngError as e:
            out.append(str(e))
    return out


@pytest.mark.parametrize("desired", [3, 4])
def test_pngreader_matches(images, desired):
    """load_png on the conftest shapes (1-pass, 2-pass and stored files of
    each) and on corrupted copies: same pixels, or the same error."""
    rng = np.random.default_rng(desired)
    n_err = 0
    for k, img in enumerate(images):
        h, w, c = img.shape
        flags = (0, FC.FPNG_ENCODE_SLOWER, FC.FPNG_FORCE_UNCOMPRESSED)[k % 3]
        png = Fgolden.encode_image_to_memory(img, w, h, c, flags)
        bad = bytearray(png)
        bad[int(rng.integers(8, len(bad)))] ^= 0x10
        for data in (png, bytes(bad)):
            got, want = _load_both(data, desired)
            if isinstance(want, str):
                assert got == want
                n_err += 1
                continue
            assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]
        assert np.array_equal(_load_both(png, desired)[0][0][..., :c],
                              img[..., :desired])
    assert n_err > 0


def _damaged(png: bytes) -> list[bytes]:
    """tests/test_pngcheck.py's structural damage classes, applied to png."""
    import struct
    import zlib

    out = []
    bad = bytearray(png)
    bad[-5] ^= 0xFF  # IEND CRC
    out.append(bytes(bad))
    out += [b"\x88" + png[1:], png + b"xx", png + png[-12:],
            png[:8] + png[33:50] + png[8:33] + png[50:], png[:len(png) - 20]]
    bad = bytearray(png)  # zlib damage under a fixed-up IDAT CRC
    idat_len = struct.unpack(">I", png[50:54])[0]
    bad[60] ^= 0xFF
    bad[58 + idat_len:62 + idat_len] = struct.pack(
        ">I", zlib.crc32(bytes(bad[54:58 + idat_len])))
    out.append(bytes(bad))
    bad = bytearray(png)  # illegal bit depth for the color type
    bad[24] = 7
    bad[29:33] = struct.pack(">I", zlib.crc32(bytes(bad[12:29])))
    out.append(bytes(bad))
    return out


@pytest.mark.parametrize("which", ["encoded", "damaged", "corrupted"])
def test_pngcheck_matches(files, which):
    """check() on the port's copy and fpng_tpu's: the same violations, in
    the same order, on clean files of every mode, on each structural
    damage class and on random byte flips."""
    clean, corrupted = files
    datas = {"encoded": clean,
             "damaged": [d for png in clean[:6] for d in _damaged(png)],
             "corrupted": corrupted}[which]
    flagged = 0
    for data in datas:
        got = Tpngcheck.check(data)
        assert got == Fpngcheck.check(data)
        flagged += bool(got)
    assert flagged == (0 if which == "encoded" else len(datas))
