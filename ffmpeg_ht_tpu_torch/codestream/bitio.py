"""Byte and bit readers for codestream parsing.

`ByteReader` mirrors the subset of bytestream2 the reference decoder uses.
`PacketBitReader` is the bit-stuffed packet-header reader of ISO 15444-1
B.10.1: after any 0xFF byte, the next byte carries only 7 payload bits
(parity: jpeg2000dec.c:70-90).
"""

from __future__ import annotations

from ffmpeg_ht_tpu_torch.utils.errors import InvalidData


class ByteReader:
    __slots__ = ("buf", "pos", "end")

    def __init__(self, buf: bytes, start: int = 0, end: int | None = None):
        self.buf = buf
        self.pos = start
        self.end = len(buf) if end is None else end

    def bytes_left(self) -> int:
        return self.end - self.pos

    def tell(self) -> int:
        return self.pos

    def seek(self, pos: int) -> None:
        self.pos = min(max(pos, 0), self.end)

    def skip(self, n: int) -> None:
        self.pos = min(self.pos + n, self.end)

    def u8(self) -> int:
        if self.pos >= self.end:
            return 0
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def u16(self) -> int:
        return (self.u8() << 8) | self.u8()

    def u32(self) -> int:
        return (self.u16() << 16) | self.u16()

    def peek_u8(self) -> int:
        return self.buf[self.pos] if self.pos < self.end else 0

    def peek_u16(self) -> int:
        if self.pos + 2 > self.end:
            return 0
        return (self.buf[self.pos] << 8) | self.buf[self.pos + 1]

    def peek_u32(self) -> int:
        if self.pos + 4 > self.end:
            return 0
        b = self.buf
        p = self.pos
        return (b[p] << 24) | (b[p + 1] << 16) | (b[p + 2] << 8) | b[p + 3]

    def read(self, n: int) -> bytes:
        if self.bytes_left() < n:
            raise InvalidData(f"short read: want {n}, have {self.bytes_left()}")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out


class PacketBitReader:
    """Bit-stuffed MSB-first reader over a ByteReader.

    Matches get_bits/jpeg2000_flush at jpeg2000dec.c:70-90: bits are consumed
    MSB-first from the current byte; when a byte equals 0xFF the following
    byte holds 7 bits. `flush` byte-aligns and skips the stuffed byte.
    """

    __slots__ = ("g", "bit_index")

    def __init__(self, g: ByteReader):
        self.g = g
        self.bit_index = 8

    def bits(self, n: int) -> int:
        res = 0
        g = self.g
        for _ in range(n):
            res <<= 1
            if self.bit_index == 0:
                self.bit_index = 7 + (g.u8() != 0xFF)
            self.bit_index -= 1
            res |= (g.peek_u8() >> self.bit_index) & 1
        return res

    def bit(self) -> int:
        g = self.g
        if self.bit_index == 0:
            self.bit_index = 7 + (g.u8() != 0xFF)
        self.bit_index -= 1
        return (g.peek_u8() >> self.bit_index) & 1

    def flush(self) -> None:
        if self.g.u8() == 0xFF:
            self.g.skip(1)
        self.bit_index = 8

    def at_end(self) -> bool:
        return self.g.bytes_left() == 0 and self.bit_index == 8
