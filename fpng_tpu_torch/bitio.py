"""LSB-first bit stream writer/reader (host side).

Deflate streams are little-endian bit streams: each value is appended
starting at the current bit position, low bit first (RFC 1951 3.1.1).
Huffman codes are stored pre-bit-reversed so a plain LSB-first append
produces the spec's MSB-first code transmission.

The writer mirrors the semantics of the reference's accumulate-and-flush
macros (fpng.cpp:564-588) including the output-budget checks, which decide
when the encoder falls back to stored blocks.
"""

from __future__ import annotations


class BudgetExceeded(Exception):
    """Raised when the output would overflow the caller-supplied budget."""


class BitWriter:
    def __init__(self, budget: int | None = None):
        self._buf = bytearray()
        self._acc = 0          # pending bits, LSB first
        self._nacc = 0         # number of pending bits
        self.budget = budget   # byte budget (None = unlimited)

    # -- primitive ----------------------------------------------------------
    def put(self, value: int, nbits: int) -> None:
        assert 0 <= value < (1 << nbits) or nbits == 0
        self._acc |= value << self._nacc
        self._nacc += nbits

    def put_and_drain(self, value: int, nbits: int) -> None:
        """put() followed by byte-at-a-time drain (header-emit style)."""
        self.put(value, nbits)
        while self._nacc >= 8:
            if self.budget is not None and len(self._buf) + 1 > self.budget:
                raise BudgetExceeded
            self._buf.append(self._acc & 0xFF)
            self._acc >>= 8
            self._nacc -= 8

    def flush(self) -> None:
        """Flush whole bytes (token-loop style; keeps the partial byte).

        Mirrors the reference's 8-byte-window flush check: the encoder
        requires 8 spare bytes at every flush point.
        """
        if self.budget is not None and len(self._buf) + 8 > self.budget:
            raise BudgetExceeded
        while self._nacc >= 8:
            self._buf.append(self._acc & 0xFF)
            self._acc >>= 8
            self._nacc -= 8

    def force_flush(self) -> None:
        """Flush everything, zero-padding the final partial byte."""
        while self._nacc > 0:
            if self.budget is not None and len(self._buf) + 1 > self.budget:
                raise BudgetExceeded
            self._buf.append(self._acc & 0xFF)
            self._acc >>= 8
            self._nacc -= 8
        self._acc = 0
        self._nacc = 0

    def append_bytes(self, data: bytes) -> None:
        assert self._nacc == 0
        if self.budget is not None and len(self._buf) + len(data) > self.budget:
            raise BudgetExceeded
        self._buf.extend(data)

    # -- state accessors ----------------------------------------------------
    @property
    def nbytes(self) -> int:
        return len(self._buf)

    @property
    def pending(self) -> tuple[int, int]:
        """(bits, count) still in the accumulator."""
        return self._acc, self._nacc

    def set_pending(self, acc: int, nacc: int) -> None:
        assert self._nacc == 0
        self._acc, self._nacc = acc, nacc

    def getvalue(self) -> bytes:
        assert self._nacc == 0, "force_flush() before reading the stream"
        return bytes(self._buf)


class BitReader:
    """LSB-first reader over a byte buffer.

    Reads are clamped: peeking past the end returns zero bits, and the
    consumer is expected to bound-check `consumed_bytes()` against the
    stream length (the fpng decoder's read-ahead works because the 4-byte
    adler32 tail always follows the deflate stream).
    """

    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0  # absolute bit position

    def peek(self, nbits: int) -> int:
        byte0 = self._pos >> 3
        # gather enough bytes (nbits <= 32 -> 5 bytes always suffice)
        chunk = self._data[byte0:byte0 + ((nbits + 7 + (self._pos & 7)) >> 3) + 1]
        v = int.from_bytes(chunk, "little")
        return (v >> (self._pos & 7)) & ((1 << nbits) - 1)

    def skip(self, nbits: int) -> None:
        self._pos += nbits

    def get(self, nbits: int) -> int:
        v = self.peek(nbits)
        self._pos += nbits
        return v

    def align_to_byte(self) -> None:
        self._pos = (self._pos + 7) & ~7

    @property
    def bit_pos(self) -> int:
        return self._pos

    def consumed_bytes(self) -> int:
        return (self._pos + 7) >> 3

    def overran(self, limit_bytes: int) -> bool:
        return self._pos > 8 * limit_bytes
