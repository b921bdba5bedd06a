""".rfq chunk record: self-delimiting block of encoded reads.

Wire layout (reference rfqchunk.cpp:230-311 write / 161-227 read):
  size u32 | reads u32 | flags u16 | seq_buf_size u32 | qual_buf_size u32
  | [npos_buf_size u32 iff header ENCODE_N_POS]
  | read_len_buf | name1_len_buf | [name2_len_buf] | strand_len_buf
  | [lane_buf] | [tile_buf] | [x_size u32 + x_buf] | [y_size u32 + y_buf]
  | name1_buf | [name2_buf] | strand_buf | seq_buf | qual_buf
  | [overlap_buf] | [npos_buf]

``size`` is informational only (decoders never validate it) but must match
the reference byte-for-byte, INCLUDING its accounting bug: the encoder
stores the tile byte count into the lane size field and leaves the tile
size 0 (reference rfqcodec.cpp:503-515), so ``size`` undercounts by the
lane bytes whenever lane/tile are written, and overcounts by 2 when they
are not. ``calc_total_buf_size`` reproduces that arithmetic.
"""

from __future__ import annotations

import numpy as np

from ..constants import (
    BIT_ENCODE_PE_BY_OVERLAP,
    BIT_LANE_SAME,
    BIT_NAME1_LEN_SAME,
    BIT_NAME1_SAME,
    BIT_NAME2_LEN_SAME,
    BIT_NAME2_SAME,
    BIT_PE_INTERLEAVED,
    BIT_READ_LEN_SAME,
    BIT_STRAND_LEN_SAME,
    BIT_STRAND_SAME,
    BIT_TILE_SAME,
)
from ..util import read_exact, u16le, u32le
from .header import RfqFormatError, RfqHeader


class RfqChunk:
    """In-memory chunk; all buffers are raw ``bytes`` in wire layout."""

    def __init__(self, header: RfqHeader):
        self.header = header
        self.size = 0
        self.reads = 0
        self.flags = 0
        self.seq_buf_size = 0
        self.qual_buf_size = 0
        self.npos_buf_size = 0
        self.x_buf_size = 0
        self.y_buf_size = 0

        self.read_len_buf = b""
        self.name1_len_buf = b""
        self.name2_len_buf = b""
        self.strand_len_buf = b""
        self.lane_buf = b""
        self.tile_buf = b""  # little-endian u16s
        self.x_buf = b""
        self.y_buf = b""
        self.name1_buf = b""
        self.name2_buf = b""
        self.strand_buf = b""
        self.seq_buf = b""
        self.qual_buf = b""
        self.overlap_buf = b""
        self.npos_buf = b""

        # size accounting fields mirroring the reference encoder's members
        # (reference rfqcodec.cpp:453-515); see calc_total_buf_size.
        self.read_len_buf_size = 0
        self.name1_len_buf_size = 0
        self.name2_len_buf_size = 0
        self.strand_len_buf_size = 0
        self.lane_buf_size = 0
        self.tile_buf_size = 0
        self.name1_buf_size = 0
        self.name2_buf_size = 0
        self.strand_buf_size = 0

    # ---- helpers ----
    def _lane_count(self) -> int:
        if self.flags & BIT_LANE_SAME:
            return 1
        if self.flags & BIT_PE_INTERLEAVED:
            return self.reads // 2
        return self.reads

    def _tile_count(self) -> int:
        if self.flags & BIT_TILE_SAME:
            return 1
        if self.flags & BIT_PE_INTERLEAVED:
            return self.reads // 2
        return self.reads

    def read_lengths(self) -> np.ndarray:
        """Per-read lengths as uint32, expanding the SAME-flag case."""
        nbytes = self.header.read_length_bytes
        dtype = {1: np.uint8, 2: np.uint16, 4: np.uint32}.get(nbytes)
        if dtype is None:
            raise RfqFormatError("header incorrect: read length bytes should be 1/2/4")
        arr = np.frombuffer(self.read_len_buf, dtype=dtype).astype(np.uint32)
        if self.flags & BIT_READ_LEN_SAME:
            return np.full(self.reads, arr[0], dtype=np.uint32)
        return arr[: self.reads]

    def calc_total_buf_size(self) -> None:
        """Reproduce reference rfqchunk.cpp:141-159 arithmetic (with quirk)."""
        size = 4 + 4 + 2 + 4 + 4
        size += (
            self.read_len_buf_size
            + self.name1_len_buf_size
            + self.name2_len_buf_size
            + self.strand_len_buf_size
        )
        size += (
            self.lane_buf_size
            + self.tile_buf_size
            + self.name1_buf_size
            + self.name2_buf_size
            + self.strand_buf_size
        )
        size += self.seq_buf_size + self.qual_buf_size
        if (self.flags & BIT_PE_INTERLEAVED) and (
            self.header.flags & BIT_ENCODE_PE_BY_OVERLAP
        ):
            size += self.reads // 2
        if self.header.encode_n_pos():
            size += 4 + self.npos_buf_size
        if self.header.has_x():
            size += 4 + self.x_buf_size
        if self.header.has_y():
            size += 4 + self.y_buf_size
        self.size = size

    # ---- serialization ----
    def to_segments(self) -> list:
        """Wire-order byte segments labeled by stream kind:
        ``b"".join(data for _, data) == to_bytes()`` exactly. The labels
        let the `.rfqz` entropy stage cut its sections at stream
        boundaries — each stream type has very different statistics, and
        mixing them in one model costs several ratio points."""
        meta = bytearray()
        meta += u32le(self.size)
        meta += u32le(self.reads)
        meta += u16le(self.flags)
        meta += u32le(self.seq_buf_size)
        meta += u32le(self.qual_buf_size)
        if self.header.encode_n_pos():
            meta += u32le(self.npos_buf_size)

        meta += self.read_len_buf
        meta += self.name1_len_buf
        if self.header.has_name2():
            meta += self.name2_len_buf
        meta += self.strand_len_buf

        if self.header.has_lane():
            meta += self.lane_buf[: self._lane_count()]
        if self.header.has_tile():
            meta += self.tile_buf[: 2 * self._tile_count()]

        coords = bytearray()
        if self.header.has_x():
            coords += u32le(self.x_buf_size)
            coords += self.x_buf
        if self.header.has_y():
            coords += u32le(self.y_buf_size)
            coords += self.y_buf

        names = bytearray()
        names += self.name1_buf
        if self.header.has_name2():
            names += self.name2_buf
        names += self.strand_buf

        tail = bytearray()
        if (self.flags & BIT_PE_INTERLEAVED) and (
            self.header.flags & BIT_ENCODE_PE_BY_OVERLAP
        ):
            tail += self.overlap_buf[: self.reads // 2]
        if self.header.encode_n_pos():
            tail += self.npos_buf

        return [
            ("meta", bytes(meta)),
            ("coords", bytes(coords)),
            ("names", bytes(names)),
            ("seq", bytes(self.seq_buf)),
            ("qual", bytes(self.qual_buf)),
            ("tail", bytes(tail)),
        ]

    def to_bytes(self) -> bytes:
        return b"".join(data for _label, data in self.to_segments())

    def write(self, stream) -> None:
        stream.write(self.to_bytes())

    @classmethod
    def read(cls, stream, header: RfqHeader,
             skip_payload: bool = False) -> "RfqChunk":
        """Parse one chunk. At EOF all fields read as 0 (like the reference's
        failed istream reads, rfqchunk.cpp:161-171), yielding the reads==0
        terminator chunk.

        skip_payload=True is the chunk-INDEX pass for parallel decompress:
        the frame fields and length arrays are parsed (they determine the
        payload sizes — the wire ``size`` field is unreliable, see module
        docstring) but the payload buffers are seeked over, not read, so a
        scan of an N-GB container touches only the small metadata. The
        returned chunk has valid reads/flags/sizes and empty payloads."""
        c = cls(header)

        if skip_payload and stream.seekable():
            def _payload(n: int) -> bytes:
                stream.seek(n, 1)
                return b""
        else:
            def _payload(n: int) -> bytes:
                return read_exact(stream, n)

        def _u32() -> int:
            raw = read_exact(stream, 4)
            return int.from_bytes(raw, "little") if len(raw) == 4 else 0

        def _u16() -> int:
            raw = read_exact(stream, 2)
            return int.from_bytes(raw, "little") if len(raw) == 2 else 0

        c.size = _u32()
        c.reads = _u32()
        c.flags = _u16()
        c.seq_buf_size = _u32()
        c.qual_buf_size = _u32()
        if header.encode_n_pos():
            c.npos_buf_size = _u32()

        # read length array (reference rfqchunk.cpp:41-61)
        rl_count = 1 if (c.flags & BIT_READ_LEN_SAME) else c.reads
        c.read_len_buf = read_exact(stream, rl_count * header.read_length_bytes)

        # name1 lengths (reference rfqchunk.cpp:63-77)
        n1_count = 1 if (c.flags & BIT_NAME1_LEN_SAME) else c.reads
        c.name1_len_buf = read_exact(stream, n1_count)
        c.name1_buf_size = sum(c.name1_len_buf)
        if (c.flags & BIT_NAME1_LEN_SAME) and not (c.flags & BIT_NAME1_SAME):
            c.name1_buf_size *= c.reads

        if header.has_name2():
            n2_count = 1 if (c.flags & BIT_NAME2_LEN_SAME) else c.reads
            c.name2_len_buf = read_exact(stream, n2_count)
            c.name2_buf_size = sum(c.name2_len_buf)
            if (c.flags & BIT_NAME2_LEN_SAME) and not (c.flags & BIT_NAME2_SAME):
                c.name2_buf_size *= c.reads

        st_count = 1 if (c.flags & BIT_STRAND_LEN_SAME) else c.reads
        c.strand_len_buf = read_exact(stream, st_count)
        c.strand_buf_size = sum(c.strand_len_buf)
        if (c.flags & BIT_STRAND_LEN_SAME) and not (c.flags & BIT_STRAND_SAME):
            c.strand_buf_size *= c.reads

        if header.has_lane():
            c.lane_buf = _payload(c._lane_count())
        if header.has_tile():
            c.tile_buf = _payload(2 * c._tile_count())

        if header.has_x():
            c.x_buf_size = _u32()
            c.x_buf = _payload(c.x_buf_size)
        if header.has_y():
            c.y_buf_size = _u32()
            c.y_buf = _payload(c.y_buf_size)

        c.name1_buf = _payload(c.name1_buf_size)
        if header.has_name2():
            c.name2_buf = _payload(c.name2_buf_size)
        c.strand_buf = _payload(c.strand_buf_size)

        c.seq_buf = _payload(c.seq_buf_size)
        c.qual_buf = _payload(c.qual_buf_size)

        if (c.flags & BIT_PE_INTERLEAVED) and (
            header.flags & BIT_ENCODE_PE_BY_OVERLAP
        ):
            c.overlap_buf = _payload(c.reads // 2)
        if header.encode_n_pos():
            c.npos_buf = _payload(c.npos_buf_size)
        return c
