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

Kernel B6 (csrc/expand.cu) does this in one launch that reads each slot
once and writes each byte once: a block owns a band of rows and walks its
strips of columns, fills them with a block-wide segmented scan, sums the
columns down the band, and takes the sum of the bands above by decoupled
look-back (tiling() sets the band and strip sizes).
"""

from __future__ import annotations

import torch

from .. import kernels as K

_TILE_SLOTS = 12288  # csrc/expand.cu: kTileSlots, kStripMax, kRowsMax
_STRIP_MAX = 4096
_ROWS_MAX = 256


def tiling(h: int, bpl: int) -> tuple[int, int, int, int]:
    """B6's tiles for h rows of bpl slots: (rows a band R, strip width S,
    bands, strips).  A row of up to 4096 slots is one strip; a wider one is
    cut into strips of a multiple of 16 slots.  R fills 12288 slots of
    shared memory (rows padded to 16), at most 256 rows and at most h."""
    n_strips = -(-bpl // _STRIP_MAX)
    per = -(-bpl // n_strips)
    S = per if n_strips == 1 else -(-per // 16) * 16
    n_strips = -(-bpl // S)
    R = max(1, min(h, _ROWS_MAX, _TILE_SLOTS // (-(-S // 16) * 16)))
    return R, S, -(-h // R), n_strips


def _scratch_bytes(B: int, S: int, bands: int, n_strips: int) -> int:
    """Bytes of B6's scratch: the ticket and a flag a tile (zeroed by the
    kernel's entry point), then an aggregate and an inclusive sum a tile,
    S rounded up to 16 bytes each."""
    tiles = B * bands * n_strips
    return -(-(4 + 4 * tiles) // 16) * 16 + 2 * tiles * (-(-S // 16) * 16)


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
    A CPU tensor takes expand_plain; a CUDA tensor launches the kernel
    (one launch, counted in `expand.launches`, after a memset of its
    scratch's flags) or raises.
    """
    if raster.device.type == "cpu":
        return expand_plain(raster, h=h, w=w, c=c)
    B = raster.shape[0]
    if raster.dtype != torch.int16 or not raster.is_contiguous() or \
            raster.shape != (B, h * w * c):
        raise ValueError("expand: raster must be a contiguous (B, h*w*c) "
                         "int16 tensor")
    out = torch.empty((B, h, w, c), dtype=torch.uint8, device=raster.device)
    if out.numel() == 0:
        return out
    R, S, bands, n_strips = tiling(h, w * c)
    if not 1 <= c <= 4 or out.numel() >= 1 << 40 or B * bands >= 1 << 31:
        raise ValueError("expand: raster too large or c outside [1, 4]")
    scratch = torch.empty((_scratch_bytes(B, S, bands, n_strips),),
                          dtype=torch.uint8, device=raster.device)
    K.check(K.lib().fpng_expand(raster.data_ptr(), B, h, w, c, R, S, bands,
                                scratch.data_ptr(), out.data_ptr(),
                                K.stream_ptr(raster.device)), "fpng_expand")
    expand.launches += 1
    return out


expand.launches = 0
