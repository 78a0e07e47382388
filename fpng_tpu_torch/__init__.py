"""fpng_tpu_torch - the fpng_tpu codec in PyTorch, with CUDA kernels for
NVIDIA Hopper (counterpart of fpng_tpu/__init__.py).

The single-image API mirrors the reference's entry points (fpng.h:17-111);
the batched API (encode_batch / decode_batch) runs one device pass per
same-shape batch on `device`.  Outputs are byte-identical to fpng_tpu's.

A CUDA tensor goes through the port's hand-written kernels (built from
fpng_tpu_torch/csrc on first use); a CPU tensor goes through their plain
torch versions.  There is no fallback between the two: a kernel that fails
to build or launch raises.

Importing this package needs neither a card nor a CUDA toolchain.  It
imports no JAX and nothing of fpng_tpu: it keeps its own copy of the
framework-free host layer (constants, bitio, huffman, container, golden,
tables, train, runtime).
"""

from __future__ import annotations

import numpy as np

from .constants import (  # noqa: F401  (public API re-exports)
    FPNG_DECODE_FAILED_CHUNK_PARSING,
    FPNG_DECODE_FAILED_DIMENSIONS_TOO_LARGE,
    FPNG_DECODE_FAILED_HEADER_CRC32,
    FPNG_DECODE_FAILED_INVALID_DIMENSIONS,
    FPNG_DECODE_FAILED_INVALID_IDAT,
    FPNG_DECODE_FAILED_NOT_PNG,
    FPNG_DECODE_FILE_OPEN_FAILED,
    FPNG_DECODE_FILE_READ_FAILED,
    FPNG_DECODE_FILE_SEEK_FAILED,
    FPNG_DECODE_FILE_TOO_LARGE,
    FPNG_DECODE_INVALID_ARG,
    FPNG_DECODE_NOT_FPNG,
    FPNG_DECODE_SUCCESS,
    FPNG_ENCODE_SLOWER,
    FPNG_FORCE_UNCOMPRESSED,
)
from .container import adler32 as fpng_adler32  # noqa: F401
from .container import crc32 as fpng_crc32  # noqa: F401
from .container import get_info as fpng_get_info  # noqa: F401

__version__ = "0.1.0"


def fpng_init() -> None:
    """Library init; the kernels are built lazily on the first CUDA call."""


def fpng_encode_image_to_memory(image, w: int, h: int, num_chans: int,
                                flags: int = 0,
                                device="cuda") -> bytes | None:
    """Single-image encode (fpng.h:48 parity); None on invalid input."""
    from .models.encoder import _validate

    img = np.asarray(image, dtype=np.uint8)
    if img.size != w * h * num_chans or num_chans not in (3, 4):
        return None
    batch = img.reshape(h, w, num_chans)[None]
    try:
        _validate(batch)
    except ValueError:
        return None
    return encode_batch(batch, flags, device)[0]


def fpng_encode_image_to_file(filename: str, image, w: int, h: int,
                              num_chans: int, flags: int = 0,
                              device="cuda") -> bool:
    data = fpng_encode_image_to_memory(image, w, h, num_chans, flags, device)
    if data is None:
        return False
    with open(filename, "wb") as f:
        f.write(data)
    return True


def fpng_decode_memory(data: bytes, desired_channels: int = 4,
                       device="cuda"):
    """(status, image (h, w, desired) | None, w, h, channels_in_file)."""
    from .models.decoder import decode_batch as _impl

    if not data or desired_channels not in (3, 4):
        return FPNG_DECODE_INVALID_ARG, None, 0, 0, 0
    statuses, images, infos = _impl(
        [bytes(data)], desired_channels, with_info=True, device=device)
    w, h, ch = infos[0]
    return statuses[0], images[0], w, h, ch


def fpng_decode_file(filename: str, desired_channels: int = 4,
                     device="cuda"):
    import os

    try:
        size = os.path.getsize(filename)
    except OSError:
        return FPNG_DECODE_FILE_OPEN_FAILED, None, 0, 0, 0
    if size > 0xFFFFFFFF:
        return FPNG_DECODE_FILE_TOO_LARGE, None, 0, 0, 0
    try:
        with open(filename, "rb") as f:
            data = f.read()
    except OSError:
        return FPNG_DECODE_FILE_READ_FAILED, None, 0, 0, 0
    return fpng_decode_memory(data, desired_channels, device)


def encode_batch(images: np.ndarray, flags: int = 0,
                 device="cuda") -> list[bytes]:
    """Encode a batch of same-shape (B, H, W, C) uint8 images on
    `device`."""
    from .models.encoder import encode_batch as _impl

    return _impl(images, flags, device)


def decode_batch(pngs: list[bytes], desired_channels: int = 4,
                 device="cuda"):
    """Decode a batch of fpng PNGs on `device`; returns (statuses,
    images)."""
    from .models.decoder import decode_batch as _impl

    return _impl(pngs, desired_channels, device=device)
