"""Data-parallel RLE match resolution (counterpart of fpng_tpu/ops/tokenize.py).

The reference's greedy loop (fpng.cpp:1045-1082) as three row-wise scans:
pixel equality with the left neighbour, a forward running max locating the
last literal pixel, and a backward running min locating the next one.  The
255/252-byte cap is then an elementwise predicate.
"""

from __future__ import annotations

import torch

from ..constants import MATCH_CAP_PIXELS


def match_fields(deltas: torch.Tensor, num_chans: int):
    """(B, H, W, C) uint8 filtered pixels -> (eq, match_start, match_px_len).

    eq (B, H, W) bool: pixel equals its left neighbour; match_start bool:
    a match token starts here; match_px_len int32: its length in pixels.
    """
    B, H, W, _ = deltas.shape
    cap = MATCH_CAP_PIXELS[num_chans]
    dev = deltas.device

    eq = torch.zeros((B, H, W), dtype=torch.bool, device=dev)
    eq[:, :, 1:] = (deltas[:, :, 1:] == deltas[:, :, :-1]).all(dim=-1)

    x_idx = torch.arange(W, dtype=torch.int32, device=dev).expand(B, H, W)
    # last literal pixel at or before x (pixel 0 is always literal)
    lit_before = torch.where(eq, -1, x_idx)
    last_lit = torch.cummax(lit_before, dim=2).values
    pos_in_run = x_idx - last_lit  # >= 1 for match pixels

    # first literal pixel at or after x (W = row end): a backward cummin,
    # written as a cummax of negatives over the flipped row
    lit_after = torch.where(eq, W, x_idx)
    next_lit = -torch.cummax(-lit_after.flip(2), dim=2).values.flip(2)

    match_start = eq & (((pos_in_run - 1) % cap) == 0)
    run_rem = next_lit - x_idx
    match_px_len = torch.where(match_start, torch.clamp(run_rem, max=cap), 0)
    return eq, match_start, match_px_len.to(torch.int32)
