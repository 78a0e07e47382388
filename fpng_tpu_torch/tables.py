"""The codec's parameters as torch tensors.

The 1-pass encoder's Huffman tables and serialized block prefix are the
only parameters fpng has; both packages read the same arrays from
fpng_tpu.tables (the checked-in artifact, fpng_tpu/_tables_data.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fpng_tpu.tables import get_one_pass_tables

from .ops.encfuse import pack_table


class OnePassState(NamedTuple):
    prefix: bytes          # zlib header + dynamic block header bytes
    acc: int               # pending sub-byte tail of the prefix ...
    nacc: int              # ... and its bit count (<= 7)
    codes: torch.Tensor    # (288,) int64 literal/length codes
    sizes: torch.Tensor    # (288,) int64 code lengths
    tbl: torch.Tensor      # (8, 128) int32 packed code | size << 16


def one_pass_state(num_chans: int, device) -> OnePassState:
    """The 1-pass tables for `num_chans` channels, on `device`."""
    prefix, acc, nacc, codes, sizes = get_one_pass_tables(num_chans)
    codes_t = torch.from_numpy(codes.astype(np.int64)).to(device)
    sizes_t = torch.from_numpy(sizes.astype(np.int64)).to(device)
    tbl = pack_table(codes_t[None], sizes_t[None])[0]
    return OnePassState(prefix, int(acc), int(nacc), codes_t, sizes_t, tbl)


def lut_to_torch(packed_lut: np.ndarray, device) -> torch.Tensor:
    """(B, 4096) uint32 packed 12-bit decode LUTs (ops/specdec.pack_lut)
    -> int64 tensor on `device`."""
    return torch.from_numpy(packed_lut.astype(np.int64)).to(device)
