""".rfq file header: 17 + qual_bins bytes at the start of every container.

Byte layout (reference rfqheader.cpp:84-97):
  magic "RFQ" | version (5B) | algorithm version (1B) | read_length_bytes (1B)
  | flags (u16 LE) | name2_diff_pos (1B) | name2_diff_char (1B)
  | n_base_qual (1B) | overlap_shift (i8) | qual_bins (1B) | qual_buf

The quality table is inferred from the FIRST chunk only (reference
repaq.cpp:553-566), so later chunks may contain out-of-table quality chars;
those are stored via the escape records of the by-column coder.
"""

from __future__ import annotations

import numpy as np

from ..constants import (
    ALGORITHM_VER,
    BIT_DONT_ENCODE_QUAL,
    BIT_ENCODE_N_POS,
    BIT_ENCODE_PE_BY_OVERLAP,
    BIT_ENCODE_QUAL_BY_COL,
    BIT_HAS_LANE,
    BIT_HAS_NAME2,
    BIT_HAS_TILE,
    BIT_HAS_X,
    BIT_HAS_Y,
    BIT_PAIRED_END,
    DEFAULT_OVERLAP_SHIFT,
    MAGIC,
    VERSION_NUM,
)
from ..util import read_exact, u16le
from ..codec import _native

_N = ord("N")


class RfqFormatError(Exception):
    """Raised for malformed containers or unsupported inputs."""


class RfqHeader:
    def __init__(self):
        self.magic = bytearray(MAGIC)
        self.version = bytearray(VERSION_NUM.ljust(5, b"\0")[:5])
        self.algorithm_version = ALGORITHM_VER
        self.read_length_bytes = 1
        self.flags = 0
        self.name2_diff_pos = 0  # uint8
        self.name2_diff_char = 0  # stored byte of the differing char, 0 = none
        self.n_base_qual = ord("#")  # stored byte; 0xFF means "N-pos encoded"
        self.overlap_shift = DEFAULT_OVERLAP_SHIFT  # signed
        self.qual_bins = 0
        self.qual_buf = b""
        # in-memory only, never serialized (reference rfqheader.h:91-99)
        self.support_interleaved = False
        # derived tables
        self.qual2bit = np.zeros(256, dtype=np.uint8)
        self.bit2qual = np.zeros(256, dtype=np.uint8)
        self.normal_qual_num_bits = 0

    # ---- flag accessors ----
    def has_lane(self) -> bool:
        return bool(self.flags & BIT_HAS_LANE)

    def has_tile(self) -> bool:
        return bool(self.flags & BIT_HAS_TILE)

    def has_x(self) -> bool:
        return bool(self.flags & BIT_HAS_X)

    def has_y(self) -> bool:
        return bool(self.flags & BIT_HAS_Y)

    def has_name2(self) -> bool:
        return bool(self.flags & BIT_HAS_NAME2)

    def paired_end(self) -> bool:
        return bool(self.flags & BIT_PAIRED_END)

    def encode_pe_by_overlap(self) -> bool:
        return bool(self.flags & BIT_ENCODE_PE_BY_OVERLAP)

    def encode_qual_by_col(self) -> bool:
        return bool(self.flags & BIT_ENCODE_QUAL_BY_COL)

    def dont_encode_qual(self) -> bool:
        return bool(self.flags & BIT_DONT_ENCODE_QUAL)

    def encode_n_pos(self) -> bool:
        return bool(self.flags & BIT_ENCODE_N_POS)

    # ---- derived quality tables ----
    def major_qual(self) -> int:
        return int(self.bit2qual[0])

    def major_qual_num_bits(self) -> int:
        return 7  # reference rfqheader.cpp:255-257

    def _make_qual_bit_table(self) -> None:
        # bin 0 (major) -> code 0, bin i>=1 -> odd code 2i-1
        # (reference rfqheader.cpp:103-115)
        self.qual2bit = np.zeros(256, dtype=np.uint8)
        self.bit2qual = np.zeros(256, dtype=np.uint8)
        for i, q in enumerate(self.qual_buf):
            bit = 0 if i == 0 else 2 * i - 1
            self.qual2bit[q] = bit
            self.bit2qual[bit] = q
        self._compute_normal_qual_bits()

    def _compute_normal_qual_bits(self) -> None:
        # reference rfqheader.cpp:117-128
        max_qual_val = max(1, self.qual_bins * 2 - 3)
        if max_qual_val >= 64:
            self.normal_qual_num_bits = 1
        elif max_qual_val >= 32:
            self.normal_qual_num_bits = 2
        elif max_qual_val >= 16:
            self.normal_qual_num_bits = 3
        elif max_qual_val >= 8:
            self.normal_qual_num_bits = 4
        elif max_qual_val >= 4:
            self.normal_qual_num_bits = 5
        elif max_qual_val >= 2:
            self.normal_qual_num_bits = 6
        else:
            self.normal_qual_num_bits = 7

    def normal_qual_bins(self) -> int:
        # reference rfqheader.cpp:308-313: the major qual is excluded unless
        # it doubles as the N-base qual.
        if self.major_qual() == self.n_base_qual:
            return self.qual_bins
        return self.qual_bins - 1

    def normal_qual_buf(self) -> np.ndarray:
        bins = self.normal_qual_bins()
        out = []
        for q in self.qual_buf:
            if q != self.major_qual() or q == self.n_base_qual:
                out.append(q)
                if len(out) > bins:
                    break
        return np.array(out[: max(bins, 0)], dtype=np.uint8)

    # ---- quality table inference (reference rfqheader.cpp:130-237) ----
    def make_quality_table(self, seq: np.ndarray, qual: np.ndarray) -> None:
        """Build the quality palette from the first chunk's bases+quals.

        ``seq``/``qual`` are the uint8 concatenation of all reads in scan
        order (reads in file order, bases left to right), which matters for
        the order-dependent N-base policy below.
        """
        self.make_quality_table_from_stats(quality_stats(seq, qual))

    def make_quality_table_from_stats(self, st: dict) -> None:
        """Palette construction from scan statistics — the scan itself may
        run on host (quality_stats) or on device (the device engine's
        histogram kernel, codec/device_engine.py); the policy logic here is
        a pure function of the stats either way."""
        if st["empty"]:
            raise RfqFormatError("bad quality string, is this a valid FASTQ file?")
        if st["qual_ge128"]:
            raise RfqFormatError("bad quality value")
        if st["invalid_lower"]:
            raise RfqFormatError(
                "repaq doesn't support FASTQ with lowercase bases (a/t/c/g)"
            )
        if st["invalid_other"]:
            raise RfqFormatError(
                "repaq only supports FASTQ with uppercase bases (A/T/C/G/N)"
            )

        counts = st["qual_counts"]

        # N-base policy, exactly matching the sequential scan in the
        # reference (rfqheader.cpp:134-184): the first N base fixes the
        # candidate N quality; it is abandoned (-> encode N positions) when
        # (a) another N base has a different quality, (b) a non-N base after
        # the first N carries the candidate quality, or (c) fewer than 100 N
        # bases exist in the chunk.
        n_count = st["n_count"]
        encode_npos = False
        n_base_qual = -1
        if n_count > 0:
            first_q = st["first_n_qual"]
            if st["n_qual_differs"] or st["nonn_after_matches"]:
                encode_npos = True
            else:
                n_base_qual = first_q
        if n_count < 100:
            encode_npos = True
            n_base_qual = -1
        if encode_npos:
            self.flags |= BIT_ENCODE_N_POS
            n_base_qual = -1
        self.n_base_qual = 0xFF if n_base_qual < 0 else n_base_qual

        present = np.flatnonzero(counts > 0)
        qual_bins = int(present.size)
        if qual_bins == 0:
            raise RfqFormatError("bad quality string, is this a valid FASTQ file?")
        if qual_bins >= 64:
            # raw-copy fallback (reference rfqheader.cpp:207-212)
            import sys

            print(
                "WARNING: this FASTQ file's quality bins are too complicated, "
                "which may affect the compression ratio.\n"
                "Please confirm this is a valid FASTQ file.",
                file=sys.stderr,
            )
            self.flags |= BIT_DONT_ENCODE_QUAL

        major = int(np.argmax(counts))  # lowest index wins ties
        has_n = (n_base_qual >= 0) and counts[n_base_qual] > 0

        buf = [major] + [int(q) for q in present if q != major]
        if not has_n:
            # append the (possibly 0xFF) N quality as an extra bin
            # (reference rfqheader.cpp:214-230)
            buf.append(self.n_base_qual)
            qual_bins += 1
        self.qual_bins = qual_bins
        self.qual_buf = bytes(buf)

        if self.qual_bins <= 64:
            self.flags |= BIT_ENCODE_QUAL_BY_COL

        self._make_qual_bit_table()

    # ---- serialization ----
    # (quality_stats lives at module level below)
    def to_bytes(self) -> bytes:
        out = bytearray()
        out += self.magic
        out += self.version
        out.append(self.algorithm_version & 0xFF)
        out.append(self.read_length_bytes & 0xFF)
        out += u16le(self.flags)
        out.append(self.name2_diff_pos & 0xFF)
        out.append(self.name2_diff_char & 0xFF)
        out.append(self.n_base_qual & 0xFF)
        out.append(self.overlap_shift & 0xFF)
        out.append(self.qual_bins & 0xFF)
        out += self.qual_buf
        return bytes(out)

    def write(self, stream) -> None:
        stream.write(self.to_bytes())

    @classmethod
    def read(cls, stream) -> "RfqHeader":
        h = cls()
        fixed = read_exact(stream, 17)
        if len(fixed) < 17:
            raise RfqFormatError("truncated rfq header")
        h.magic = bytearray(fixed[0:3])
        h.version = bytearray(fixed[3:8])
        h.algorithm_version = fixed[8]
        if h.algorithm_version != ALGORITHM_VER:
            raise RfqFormatError(
                "The data is encoded by different version of repaq, please try "
                "repaq v" + fixed[3:8].decode("ascii", "replace")
            )
        h.read_length_bytes = fixed[9]
        h.flags = int.from_bytes(fixed[10:12], "little")
        h.name2_diff_pos = fixed[12]
        h.name2_diff_char = fixed[13]
        h.n_base_qual = fixed[14]
        shift = fixed[15]
        h.overlap_shift = shift - 256 if shift >= 128 else shift
        h.qual_bins = fixed[16]
        h.qual_buf = read_exact(stream, h.qual_bins)
        if len(h.qual_buf) != h.qual_bins:
            raise RfqFormatError("truncated rfq header qual table")
        h._make_qual_bit_table()
        if bytes(h.magic) != MAGIC:
            raise RfqFormatError("Not a valid repaq file!")
        return h

    def identical_with(self, other: "RfqHeader") -> bool:
        return (
            bytes(self.magic) == bytes(other.magic)
            and bytes(self.version) == bytes(other.version)
            and self.algorithm_version == other.algorithm_version
            and self.read_length_bytes == other.read_length_bytes
            and self.flags == other.flags
            and self.overlap_shift == other.overlap_shift
            and self.name2_diff_pos == other.name2_diff_pos
            and self.name2_diff_char == other.name2_diff_char
            and self.qual_bins == other.qual_bins
            and self.qual_buf == other.qual_buf
            and np.array_equal(self.qual2bit, other.qual2bit)
            and np.array_equal(self.bit2qual, other.bit2qual)
            and self.normal_qual_num_bits == other.normal_qual_num_bits
            and self.n_base_qual == other.n_base_qual
        )


def quality_stats(seq: np.ndarray, qual: np.ndarray) -> dict:
    """Host scan statistics for make_quality_table_from_stats. The device
    engine computes the identical dict with on-device histograms/reduces
    (one pass over chunk 1 on the chip instead of the host)."""
    if qual.size == 0:
        return {"empty": True, "qual_ge128": False, "invalid_lower": False,
                "invalid_other": False, "qual_counts": np.zeros(128, np.int64),
                "n_count": 0, "first_n_qual": -1, "n_qual_differs": False,
                "nonn_after_matches": False}
    if _native.available() and seq.shape[0] == qual.shape[0]:
        # (length-mismatched calls — palette construction from a bare
        # qual list — take the numpy path below, which never pairs the
        # two arrays when no N is present)
        # fused native pass: both histograms + the N-quality relations at
        # memory bandwidth (~15 ms for a 27M-base chunk vs ~0.5-1.2 s of
        # separate numpy sweeps — header latency is per FILE, but the
        # bench corpora are small enough that it showed)
        sh, qh, meta = _native.quality_scan(
            np.ascontiguousarray(seq), np.ascontiguousarray(qual)
        )
        qual_ge128 = bool(qh[128:].sum() > 0)
        invalid_lower = invalid_other = False
        if meta[0] >= 0:
            if meta[0] in b"atcg":
                invalid_lower = True
            else:
                invalid_other = True
        n_count = int(sh[_N])
        differs = bool(meta[2])
        return {
            "empty": False, "qual_ge128": qual_ge128,
            "invalid_lower": invalid_lower, "invalid_other": invalid_other,
            "qual_counts": (qh[:128] if not qual_ge128
                            else np.zeros(128, np.int64)),
            "n_count": n_count,
            "first_n_qual": int(meta[1]) if n_count else -1,
            "n_qual_differs": differs,
            "nonn_after_matches": bool(meta[3]) and not differs,
        }
    qual_ge128 = bool(np.any(qual >= 128))
    # 256-entry LUT gather, not np.isin: isin's sort path costs seconds
    # on a whole-chunk scan (27M bases) where the gather is ~50 ms
    base_ok = np.zeros(256, dtype=bool)
    base_ok[np.frombuffer(b"ATCGN", dtype=np.uint8)] = True
    valid = base_ok[seq]
    invalid_lower = invalid_other = False
    if not np.all(valid):
        offender = seq[~valid][0]
        if offender in b"atcg":
            invalid_lower = True
        else:
            invalid_other = True
    counts = (np.bincount(qual, minlength=128)[:128]
              if not qual_ge128 else np.zeros(128, np.int64))
    n_mask = seq == _N
    n_count = int(np.count_nonzero(n_mask))
    first_q = -1
    n_qual_differs = nonn_after_matches = False
    if n_count > 0:
        first_n = int(np.argmax(n_mask))
        first_q = int(qual[first_n])
        n_qual_differs = bool(np.any(qual[n_mask] != first_q))
        if not n_qual_differs:
            after = np.zeros(seq.shape[0], dtype=bool)
            after[first_n:] = True
            nonn_after_matches = bool(
                np.any(after & ~n_mask & (qual == first_q))
            )
    return {"empty": False, "qual_ge128": qual_ge128,
            "invalid_lower": invalid_lower, "invalid_other": invalid_other,
            "qual_counts": counts, "n_count": n_count,
            "first_n_qual": first_q, "n_qual_differs": n_qual_differs,
            "nonn_after_matches": nonn_after_matches}
