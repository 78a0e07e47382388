"""fpng_tpu_torch's import boundary and the kernel dispatch rule on the CPU."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import fpng_tpu_torch as T
from fpng_tpu import constants as C
from fpng_tpu_torch import bench
from fpng_tpu_torch.ops.bitpack import deposit_bits, scatter_packed16
from fpng_tpu_torch.ops.checksum import crc_chunks
from fpng_tpu_torch.ops.encfuse import demote_mask, encode_bits_fused
from fpng_tpu_torch.ops.expand import expand
from fpng_tpu_torch.ops.specdec_tpu import finalize_records, walk_fix
from fpng_tpu_torch.ops.walk8 import finalize_records8, walk_fix8
from fpng_tpu_torch.tools.prof_depparts import depparts
from fpng_tpu_torch.tools.prof_depparts import inputs as depparts_inputs
from fpng_tpu_torch.tools.prof_int8mxu import int8_mxu

WRAPPERS = (encode_bits_fused, crc_chunks, deposit_bits, walk_fix8,
            finalize_records8, scatter_packed16, expand, demote_mask,
            walk_fix, finalize_records, depparts, int8_mxu)


def test_import_leaves_out_jax_and_triton():
    """Every module of the port, then a CPU encode and decode: no jax, no
    triton, and nothing of fpng_tpu in sys.modules."""
    code = (
        "import pkgutil, sys\n"
        "import numpy as np\n"
        "import fpng_tpu_torch as T\n"
        "mods = [m.name for m in pkgutil.walk_packages(T.__path__,\n"
        "                                              'fpng_tpu_torch.')]\n"
        "for m in mods:\n"
        "    __import__(m)\n"
        "img = np.random.default_rng(1).integers(0, 9, (2, 6, 5, 3),\n"
        "                                        dtype=np.uint8)\n"
        "sts, outs = T.decode_batch(T.encode_batch(img, device='cpu'), 3,\n"
        "                           device='cpu')\n"
        "assert sts == [0, 0] and (np.stack(outs) == img).all()\n"
        "bad = [m for m in sys.modules if m in ('jax', 'triton', 'fpng_tpu')\n"
        "       or m.startswith(('jax.', 'triton.', 'fpng_tpu.'))]\n"
        "print(len(mods), ','.join(bad) or 'clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         cwd=__file__.rsplit("/tests/", 1)[0])
    n, verdict = out.stdout.split()
    assert verdict == "clean", out.stdout + out.stderr
    assert int(n) >= 23  # every module of the port was imported


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """On CPU tensors the wrappers run their plain versions and never
    touch the kernel library (there is no nvcc here): every encode mode,
    both walk decodes and the probes P1 and P2."""
    from fpng_tpu_torch import kernels
    from fpng_tpu_torch.models.decoder import decode_batch

    before = [f.launches for f in WRAPPERS]
    paths = dict(decode_batch.paths)
    rng = np.random.default_rng(3)
    for c, flags, walk8 in ((3, 0, "1"), (4, 0, "1"),
                            (4, C.FPNG_ENCODE_SLOWER, "0")):
        monkeypatch.setenv("FPNG_TPU_WALK8", walk8)
        # few values, so the files compress and reach the walk decodes
        imgs = rng.integers(0, 4, (2, 9, 11, c), dtype=np.uint8)
        pngs = T.encode_batch(imgs, flags, device="cpu")
        sts, outs = T.decode_batch(pngs, c, device="cpu")
        assert sts == [0, 0]
        assert all(np.array_equal(o, i) for o, i in zip(outs, imgs))
    cu, big, ohc0 = depparts_inputs(1, 1, 1, 8, device="cpu")
    assert depparts(cu, big, ohc0, "full").shape == (1, 8, 128)
    a = torch.ones((128, 32), dtype=torch.int32)
    assert int8_mxu(a, a.T.contiguous(), dtype=torch.int8, reps=2,
                    T=3).sum() == 128 * 128 * 32 * 3
    assert decode_batch.paths["walk8"] == paths["walk8"] + 2
    assert decode_batch.paths["pk1"] == paths["pk1"] + 1
    assert [f.launches for f in WRAPPERS] == before
    assert kernels._lib is None


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
    with pytest.raises((RuntimeError, AssertionError)):
        list(T.encode_batch_stream([img]))
    with pytest.raises(RuntimeError):
        bench.main()
