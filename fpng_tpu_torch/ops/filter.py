"""Batched PNG filtering (counterpart of fpng_tpu/ops/filter.py).

The fpng filter scheme (row 0: None, rows 1..: Up) is a first difference
along the row axis; the inverse is a running sum (fpng.cpp:1592-1660).
"""

from __future__ import annotations

import torch


def filter_deltas(imgs: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) uint8 -> per-row byte deltas vs the previous scanline.

    Row 0 is returned raw (filter 0); rows 1.. are cur - prev (filter 2).
    """
    if imgs.dtype != torch.uint8:
        raise ValueError("filter_deltas expects uint8 images")
    prev = torch.zeros_like(imgs, dtype=torch.int32)
    prev[:, 1:] = imgs[:, :-1]
    return ((imgs.to(torch.int32) - prev) & 0xFF).to(torch.uint8)
