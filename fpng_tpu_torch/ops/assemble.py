"""Device-side IDAT CRC-32 for container assembly, in the word domain
(counterpart of fpng_tpu/ops/assemble.py).

The only O(bytes) compute in container assembly is the IDAT CRC-32.  One
pass reads the encoder's words once, masks each image to its live byte span
[plen, tb) and reduces 1024-word chunks to raw registers; the registers
combine into one per image.  The variable-length finish is (B,)-register
GF(2) math: unshift the padded zero tail, append the 4 big-endian adler
bytes, prepend the host-computed raw of b"IDAT" + prefix, then the standard
init/final XOR.  The host tail per image is a memcpy splice
(models/encoder.py).  Reference: fpng.cpp:1766-1800.

idat_crc_words is kernel B2 (csrc/crc_words.cu, fpng_idat_crc): the chunk
pass, the combine and the finish in one launch.  idat_crc_words_plain is
the same function as torch ops on any device (the chunk pass, a log-depth
combine tree and three variable shifts, each a chain of small ops),
independent of the kernel; the CPU path and the tests take it.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels as K
from ..models.transfer import to_device
from .checksum import (_WCRC_CW, _apply_shift_device, _shift_matrix,
                       _shift_tables_on, _word_table_on, crc32_raw4_le,
                       crc32_raw_prefix_host, crc32_var_shift,
                       crc32_var_unshift, crc32_words_masked_raw)


def _bswap32(v: torch.Tensor) -> torch.Tensor:
    """Byte swap of uint32 values held in int64."""
    return ((v >> 24) | ((v >> 8) & 0xFF00) | ((v & 0xFF00) << 8) |
            ((v & 0xFF) << 24))


def idat_crc_words_plain(words, total_bits, adler, plens,
                         raw_ip) -> torch.Tensor:
    """Plain torch version of kernel B2 (same contract as idat_crc_words),
    torch ops on any device."""
    B, NW = words.shape
    N = NW * 4
    tb = (total_bits.to(torch.int64) + 7) >> 3
    plens = torch.as_tensor(plens).to(words.device, torch.int64)
    raw_ip = torch.as_tensor(raw_ip).to(words.device, torch.int64)

    raw = crc32_words_masked_raw(words, plens, tb)
    # the registers describe the full N-byte masked buffer: strip the tail
    raw_stuff = crc32_var_unshift(raw, N - tb, N)
    # append the 4 big-endian adler bytes
    raw1 = _apply_shift_device(raw_stuff, _shift_matrix(4)) ^ \
        crc32_raw4_le(_bswap32(adler.to(torch.int64)))
    # prepend b"IDAT" + prefix: raw(A||X) = shift_{|X|}(raw(A)) ^ raw(X)
    raw_m = crc32_var_shift(raw_ip, tb + 4 - plens, N + 8) ^ raw1
    # standard CRC init/final: crc = raw ^ shift_len(0xFFFFFFFF) ^ ~0
    init = crc32_var_shift(torch.full_like(tb, 0xFFFFFFFF), tb + 8, N + 8)
    return raw_m ^ init ^ 0xFFFFFFFF


def idat_crc_words(words, total_bits, adler, plens, raw_ip) -> torch.Tensor:
    """(B,) int64 IDAT chunk CRCs straight from the encoder's outputs: the
    wrapper of kernel B2.

    words:      (B, NW) int32 LE deflate payload words, NW % 1024 == 0
    total_bits: (B,) stream length in bits (incl. the spliced prefix)
    adler:      (B,) adler32 of the filtered stream
    plens:      (B,) true prefix byte lengths (host array or tensor)
    raw_ip:     (B,) raw (init-0) CRC of b"IDAT" + prefix per image (host
                array or tensor)

    The CRC covers b"IDAT" + payload[0:tb] + adler4, where payload bytes
    [0, plen) are the host-side prefix (carried by raw_ip) and [plen, tb)
    live in `words`.  A CPU tensor takes idat_crc_words_plain; a CUDA tensor
    launches the kernel (counted in `idat_crc_words.launches`) or raises.
    plens and raw_ip go up in one copy with the kernel's two scratch words
    an image, so a call is that copy and one launch.
    """
    if words.device.type == "cpu":
        return idat_crc_words_plain(words, total_bits, adler, plens, raw_ip)
    B, NW = words.shape
    if NW % _WCRC_CW or 4 * NW + 8 >= 1 << 32:
        raise ValueError(f"idat_crc_words: word count {NW} is not a "
                         f"multiple of {_WCRC_CW} below 2^30")
    meta = np.zeros((B, 4), np.int64)
    meta[:, 0] = torch.as_tensor(plens).cpu().numpy()
    meta[:, 1] = torch.as_tensor(raw_ip).cpu().numpy()
    meta = to_device(meta.astype(np.uint32).view(np.int32), words.device)
    total_bits = total_bits.to(torch.int64).contiguous()
    adler = adler.to(torch.int64).contiguous()
    table = _word_table_on(words.device)
    shifts = _shift_tables_on(words.device)
    K.require_cuda("idat_crc_words", words, meta, table, shifts)
    K.require_cuda("idat_crc_words", total_bits, adler, dtype=torch.int64)
    crc = torch.empty((B,), dtype=torch.int64, device=words.device)
    K.check(K.lib().fpng_idat_crc(
        words.data_ptr(), total_bits.data_ptr(), adler.data_ptr(),
        meta.data_ptr(), table.data_ptr(), shifts.data_ptr(), B, NW,
        crc.data_ptr(), K.stream_ptr(words.device)), "fpng_idat_crc")
    idat_crc_words.launches += 1
    return crc


idat_crc_words.launches = 0


def raw_idat_prefix(prefixes: list[bytes]) -> np.ndarray:
    """Host-side per-image raw CRC registers of b"IDAT" + prefix; computed
    once and broadcast when the batch shares one prefix (1-pass tables)."""
    if prefixes and all(p is prefixes[0] for p in prefixes):
        one = crc32_raw_prefix_host([b"IDAT" + prefixes[0]])
        return np.broadcast_to(one, (len(prefixes),)).copy()
    return crc32_raw_prefix_host([b"IDAT" + p for p in prefixes])
