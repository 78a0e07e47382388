"""fpng_tpu_torch's import boundary and the kernel dispatch rule on the CPU."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import fpng_tpu_torch as T
from fpng_tpu import constants as C
from fpng_tpu_torch.ops.bitpack import deposit_bits
from fpng_tpu_torch.ops.checksum import crc_chunks
from fpng_tpu_torch.ops.encfuse import encode_bits_fused


def test_import_leaves_out_jax_and_triton():
    code = (
        "import sys\n"
        "import fpng_tpu_torch, fpng_tpu_torch.tables\n"
        "import fpng_tpu_torch.models.encoder, fpng_tpu_torch.models.decoder\n"
        "import fpng_tpu_torch.ops.assemble, fpng_tpu_torch.ops.specdec\n"
        "bad = [m for m in ('jax', 'triton') if m in sys.modules]\n"
        "print(','.join(bad) or 'clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         cwd=__file__.rsplit("/tests/", 1)[0])
    assert out.stdout.strip() == "clean", out.stdout + out.stderr


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors the wrappers run their plain versions and never
    touch the kernel library (there is no nvcc here)."""
    from fpng_tpu_torch import kernels

    before = (encode_bits_fused.launches, crc_chunks.launches,
              deposit_bits.launches)
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (2, 9, 11, 3), dtype=np.uint8)
    pngs = T.encode_batch(imgs, 0, device="cpu")
    sts, outs = T.decode_batch(pngs, 3, device="cpu")
    assert sts == [0, 0]
    assert all(np.array_equal(o, i) for o, i in zip(outs, imgs))
    assert (encode_bits_fused.launches, crc_chunks.launches,
            deposit_bits.launches) == before
    assert kernels._lib is None


@pytest.mark.parametrize("flags,chans", [(C.FPNG_ENCODE_SLOWER, 3), (0, 4)])
def test_unported_modes_raise(flags, chans):
    img = np.zeros((1, 4, 4, chans), np.uint8)
    with pytest.raises(NotImplementedError):
        T.encode_batch(img, flags, device="cpu")


def test_invalid_input_is_none_or_invalid_arg():
    assert T.fpng_encode_image_to_memory(np.zeros(5, np.uint8), 2, 2, 3,
                                         device="cpu") is None
    assert T.fpng_encode_image_to_memory(np.zeros(8, np.uint8), 2, 2, 2,
                                         device="cpu") is None
    assert T.fpng_decode_memory(b"", 3, device="cpu")[0] == \
        C.FPNG_DECODE_INVALID_ARG
    assert T.fpng_decode_memory(b"x" * 80, 5, device="cpu")[0] == \
        C.FPNG_DECODE_INVALID_ARG
    assert T.fpng_decode_memory(b"x" * 80, 3, device="cpu")[0] == \
        C.FPNG_DECODE_FAILED_NOT_PNG


def test_file_entry_points_roundtrip(tmp_path):
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (6, 10, 3), dtype=np.uint8)
    path = str(tmp_path / "a.png")
    assert T.fpng_encode_image_to_file(path, img, 10, 6, 3, device="cpu")
    st, out, w, h, ch = T.fpng_decode_file(path, 4, device="cpu")
    assert (st, w, h, ch) == (0, 10, 6, 3)
    assert np.array_equal(out[..., :3], img) and (out[..., 3] == 255).all()
    assert T.fpng_decode_file(str(tmp_path / "missing.png"))[0] == \
        C.FPNG_DECODE_FILE_OPEN_FAILED
    with open(path, "rb") as f:
        assert T.fpng_get_info(f.read())[:4] == (0, 10, 6, 3)


def test_cuda_tensor_without_card_raises():
    """No CPU fallback for a CUDA request: without a card it raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    img = np.zeros((1, 4, 4, 3), np.uint8)
    with pytest.raises((RuntimeError, AssertionError)):
        T.encode_batch(img, 0)
