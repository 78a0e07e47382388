"""Peaks of the card and the bytes each layer's work needs.

The bytes are counted from what the work has to move, whatever kernels
implement it: a decode reads each zlib stream once and writes each
raster once; an encode reads each raster once and writes each file's
zlib stream once.  A fusion, or a kernel taken off the path, leaves the
count valid.  The arithmetic is `chip_smoke.py:bound`'s (bytes over the
HBM rate), counted a layer and not a kernel.
"""

from __future__ import annotations

from pngbench import pngref

# NVIDIA H100 SXM data sheet (dense rates, 700 W): HBM3 bytes a second
PEAKS = {"NVIDIA H100 80GB HBM3": {"hbm_bytes_s": 3.35e12}}
DEFAULT_CARD = "NVIDIA H100 80GB HBM3"


def hbm_bytes_s(card: str) -> float:
    return PEAKS.get(card, PEAKS[DEFAULT_CARD])["hbm_bytes_s"]


def file_info(png, shape) -> tuple:
    """(zlib bytes, h, w, c, decoded on the card) of one file of an
    (h, w, c) raster; a file that is not a PNG counts nothing."""
    try:
        return (pngref.idat_bytes(png), *shape, not pngref.is_stored(png))
    except (pngref.BadPNG, IndexError, TypeError):
        return (0, *shape, False)


def decode_bytes(files) -> int:
    """HBM bytes a device decode of `files` needs: [(zlib_bytes, h, w, c,
    on_card)], each zlib stream read once and each raster written once;
    files the host decodes (stored blocks) count nothing."""
    return sum(z + h * w * c for z, h, w, c, on_card in files if on_card)


def encode_bytes(files) -> int:
    """HBM bytes a device encode needs: [(zlib_bytes, h, w, c, _)], each
    raster read once and each file's zlib stream written once (the card
    deposits every stream, also those the host then stores)."""
    return sum(z + h * w * c for z, h, w, c, _ in files)


def share(nbytes: float, busy_s: float, card: str) -> float | None:
    """Percent of the card's time that the bytes need at the HBM rate;
    None when nothing ran."""
    if busy_s <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / hbm_bytes_s(card) / busy_s
