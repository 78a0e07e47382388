"""Device-side IDAT CRC-32 for container assembly, in the word domain
(counterpart of fpng_tpu/ops/assemble.py).

The only O(bytes) compute in container assembly is the IDAT CRC-32.  One
pass (kernel B2) reads the encoder's words once, masks each image to its
live byte span [plen, tb) and reduces 1024-word chunks to raw registers; a
log-depth tree combines them.  The variable-length finish is (B,)-register
GF(2) math: unshift the padded zero tail, append the 4 big-endian adler
bytes, prepend the host-computed raw of b"IDAT" + prefix, then the standard
init/final XOR.  The host tail per image is a memcpy splice
(models/encoder.py).  Reference: fpng.cpp:1766-1800.
"""

from __future__ import annotations

import numpy as np
import torch

from .checksum import (_apply_shift_device, _shift_matrix, crc32_raw4_le,
                       crc32_raw_prefix_host, crc32_var_shift,
                       crc32_var_unshift, crc32_words_masked_raw)


def _bswap32(v: torch.Tensor) -> torch.Tensor:
    """Byte swap of uint32 values held in int64."""
    return ((v >> 24) | ((v >> 8) & 0xFF00) | ((v & 0xFF00) << 8) |
            ((v & 0xFF) << 24))


def idat_crc_words(words, total_bits, adler, plens, raw_ip) -> torch.Tensor:
    """(B,) int64 IDAT chunk CRCs straight from the encoder's outputs.

    words:      (B, NW) int32 LE deflate payload words, NW % 1024 == 0
    total_bits: (B,) stream length in bits (incl. the spliced prefix)
    adler:      (B,) adler32 of the filtered stream
    plens:      (B,) true prefix byte lengths
    raw_ip:     (B,) raw (init-0) CRC of b"IDAT" + prefix per image

    The CRC covers b"IDAT" + payload[0:tb] + adler4, where payload bytes
    [0, plen) are the host-side prefix (carried by raw_ip) and [plen, tb)
    live in `words`.
    """
    B, NW = words.shape
    N = NW * 4
    tb = (total_bits.to(torch.int64) + 7) >> 3
    plens = plens.to(torch.int64)

    raw = crc32_words_masked_raw(words, plens, tb)
    # the registers describe the full N-byte masked buffer: strip the tail
    raw_stuff = crc32_var_unshift(raw, N - tb, N)
    # append the 4 big-endian adler bytes
    raw1 = _apply_shift_device(raw_stuff, _shift_matrix(4)) ^ \
        crc32_raw4_le(_bswap32(adler.to(torch.int64)))
    # prepend b"IDAT" + prefix: raw(A||X) = shift_{|X|}(raw(A)) ^ raw(X)
    raw_m = crc32_var_shift(raw_ip.to(torch.int64), tb + 4 - plens,
                            N + 8) ^ raw1
    # standard CRC init/final: crc = raw ^ shift_len(0xFFFFFFFF) ^ ~0
    init = crc32_var_shift(torch.full_like(tb, 0xFFFFFFFF), tb + 8, N + 8)
    return raw_m ^ init ^ 0xFFFFFFFF


def raw_idat_prefix(prefixes: list[bytes]) -> np.ndarray:
    """Host-side per-image raw CRC registers of b"IDAT" + prefix; computed
    once and broadcast when the batch shares one prefix (1-pass tables)."""
    if prefixes and all(p is prefixes[0] for p in prefixes):
        one = crc32_raw_prefix_host([b"IDAT" + prefixes[0]])
        return np.broadcast_to(one, (len(prefixes),)).copy()
    return crc32_raw_prefix_host([b"IDAT" + p for p in prefixes])
