"""Raster expansion: deposited literal slots -> pixels (counterpart of
fpng_tpu/ops/specdec_tpu.py:expand_tpu).

The walk8 deposit leaves one 16-bit slot per data byte of the filtered
image (filter bytes excluded): sym | 0x100 where a literal was decoded, 0
where a match covers the byte.  fpng's matches copy the previous pixel
(distance = channels, fpng.cpp:2290-2549), so within a row every match
byte equals the last literal c bytes back; every row but the first is Up
filtered.  expand therefore

  1. forward-fills each row's match slots from the last literal at the
     same position mod c (a slot with no literal before it keeps its own
     low byte),
  2. adds the row above, mod 256, down the image (Up defilter),
  3. returns the bytes as (B, h, w, c) uint8.

Kernel B6 (csrc/expand.cu) does this in two launches: one thread per
(image, row, residue mod c) fills along the row, then one thread per
(image, column byte) adds down the rows.
"""

from __future__ import annotations

import torch

from .. import kernels as K


def expand_plain(raster: torch.Tensor, *, h: int, w: int,
                 c: int) -> torch.Tensor:
    """Plain torch version of kernel B6 (same contract as expand)."""
    B = raster.shape[0]
    s = raster.reshape(B, h, w, c).to(torch.int32) & 0xFFFF
    v = s & 0xFF
    lit = ((s >> 8) & 1).bool()
    xs = torch.arange(w, device=raster.device).view(1, 1, w, 1)
    last = torch.cummax(torch.where(lit, xs, -1), dim=2).values
    filled = torch.where(last >= 0, torch.gather(v, 2, last.clamp(min=0)), v)
    return (torch.cumsum(filled, dim=1) & 0xFF).to(torch.uint8)


def expand(raster: torch.Tensor, *, h: int, w: int, c: int) -> torch.Tensor:
    """Kernel B6: (B, h*w*c) int16 slot raster -> (B, h, w, c) uint8.

    Slot bits: low byte = value, bit 8 = literal; the others are ignored.
    A CPU tensor takes expand_plain; a CUDA tensor launches the kernel's
    two launches (counted in `expand.launches`) or raises.
    """
    if raster.device.type == "cpu":
        return expand_plain(raster, h=h, w=w, c=c)
    B = raster.shape[0]
    if raster.dtype != torch.int16 or not raster.is_contiguous() or \
            raster.shape != (B, h * w * c):
        raise ValueError("expand: raster must be a contiguous (B, h*w*c) "
                         "int16 tensor")
    if B * h * w * c >= 1 << 40:
        raise ValueError("expand: raster too large")
    out = torch.empty((B, h, w, c), dtype=torch.uint8, device=raster.device)
    if out.numel() == 0:
        return out
    K.check(K.lib().fpng_expand(raster.data_ptr(), B, h, w, c,
                                out.data_ptr(), K.stream_ptr(raster.device)),
            "fpng_expand")
    expand.launches += 2  # fill_kernel, defilter_kernel
    return out


expand.launches = 0
