"""Wire-format constants for the .rfq container.

Values must match the reference format exactly (reference: src/common.h:4-5,
src/rfqheader.h:23-42, src/rfqchunk.h:23-50) so that files interoperate
byte-for-byte with repaq v0.5.1 / algorithm version 2.
"""

# Version string written into the 5-byte header field (reference common.h:4).
VERSION_NUM = b"0.5.1"
# Algorithm version byte; decoders reject anything else (reference common.h:5,
# rfqheader.cpp:23-25).
ALGORITHM_VER = 2

MAGIC = b"RFQ"

# ---- header flag bits (reference rfqheader.h:23-42) ----
BIT_HAS_LANE = 1 << 0
BIT_HAS_TILE = 1 << 1
BIT_HAS_X = 1 << 2
BIT_HAS_Y = 1 << 3
BIT_HAS_NAME2 = 1 << 4
BIT_PAIRED_END = 1 << 5
BIT_ENCODE_PE_BY_OVERLAP = 1 << 6
BIT_ENCODE_QUAL_BY_COL = 1 << 7
BIT_DONT_ENCODE_QUAL = 1 << 8
BIT_ENCODE_N_POS = 1 << 9

# ---- chunk flag bits (reference rfqchunk.h:23-50) ----
BIT_READ_LEN_SAME = 1 << 0
BIT_NAME1_LEN_SAME = 1 << 1
BIT_NAME2_LEN_SAME = 1 << 2
BIT_STRAND_LEN_SAME = 1 << 3
BIT_LANE_SAME = 1 << 4
BIT_TILE_SAME = 1 << 5
BIT_NAME1_SAME = 1 << 6
BIT_NAME2_SAME = 1 << 7
BIT_STRAND_SAME = 1 << 8
BIT_PE_INTERLEAVED = 1 << 9
BIT_HAS_NO_LINE_BREAK_AT_END = 1 << 10
BIT_HAS_NO_LINE_BREAK_AT_END_R2 = 1 << 11

# Default signed shift applied to stored PE overlap bytes (reference
# rfqheader.cpp:16).
DEFAULT_OVERLAP_SHIFT = -24

# Minimum exact overlap length the PE overlap search accepts (reference
# rfqcodec.cpp:1392).
MIN_OVERLAP = 12

# Implicit initial "previous value" of the X/Y coordinate coder (reference
# rfqcodec.cpp:1269: "1000 is optimized for Illumina FASTQ").
COORD_INIT_LAST = 1000

# 2-bit base code table: G=0, A=1, T=2, C=3 (reference rfqcodec.cpp:588-609).
BASE_TO_2BIT = {ord("G"): 0, ord("A"): 1, ord("T"): 2, ord("C"): 3}
BIT2_TO_BASE = b"GATC"
