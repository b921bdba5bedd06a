"""Vectorized block codec: exact .rfq encode/decode over ReadBlock arrays.

This is the production host path (and the staging ground for the JAX device
path in repaq_tpu.ops): every per-read loop of the reference becomes array
passes over the whole chunk. Byte output is identical to the scalar oracle
(and therefore to the reference encoder); equivalence is enforced by
tests/test_vectorized.py and the golden suite.
"""

from __future__ import annotations

import numpy as np

from ..constants import (
    BIT_ENCODE_PE_BY_OVERLAP,
    BIT_HAS_LANE,
    BIT_HAS_NAME2,
    BIT_HAS_TILE,
    BIT_HAS_X,
    BIT_HAS_Y,
    BIT_LANE_SAME,
    BIT_NAME1_LEN_SAME,
    BIT_NAME1_SAME,
    BIT_NAME2_LEN_SAME,
    BIT_NAME2_SAME,
    BIT_PAIRED_END,
    BIT_PE_INTERLEAVED,
    BIT_READ_LEN_SAME,
    BIT_STRAND_LEN_SAME,
    BIT_STRAND_SAME,
    BIT_TILE_SAME,
    MIN_OVERLAP,
)
from ..format.chunk import RfqChunk
from ..format.header import RfqHeader
from . import _native
from . import kernels_np as K
from . import oracle
from .blocks import ReadBlock, gather_slices, lens_to_offsets
from .names import build_names, parse_names

_COMP = np.full(256, ord("N"), dtype=np.uint8)
for _a, _b in zip(b"AaTtCcGg", b"TTAAGGCC"):
    _COMP[_a] = _b

_HASH_BASE = np.uint64(1099511628211)


# ---------------------------------------------------------------------------
# header inference
# ---------------------------------------------------------------------------


def make_header_se(block: ReadBlock, stats_fn=None) -> RfqHeader | None:
    """stats_fn: optional override computing the quality-scan statistics
    (the device engine passes its on-device histogram kernel)."""
    if block.n == 0:
        return None
    header = RfqHeader()
    meta = parse_names(block.name_flat, block.name_off)
    if bool(meta["illumina"].all()):
        header.flags |= (
            BIT_HAS_LANE | BIT_HAS_TILE | BIT_HAS_X | BIT_HAS_Y | BIT_HAS_NAME2
        )
    if stats_fn is None:
        header.make_quality_table(block.seq_flat, block.qual_flat)
    else:
        header.make_quality_table_from_stats(stats_fn(block))
    _set_read_length_bytes(header, int(block.seq_lens().max(initial=0)))
    return header


def make_header_pe(block: ReadBlock, stats_fn=None) -> RfqHeader | None:
    """block holds interleaved pairs (r1, r2, r1, r2, ...)."""
    if block.n == 0:
        return None
    header = RfqHeader()
    meta = parse_names(block.name_flat, block.name_off)
    all_illumina = bool(meta["illumina"].all())

    support, diff_pos, diff_char = _pe_interleave_support(block, meta, all_illumina)
    if support:
        header.support_interleaved = True
        header.name2_diff_pos = diff_pos
        header.name2_diff_char = diff_char
        header.flags |= BIT_ENCODE_PE_BY_OVERLAP

    if stats_fn is None:
        header.make_quality_table(block.seq_flat, block.qual_flat)
    else:
        header.make_quality_table_from_stats(stats_fn(block))
    if all_illumina:
        header.flags |= (
            BIT_HAS_LANE | BIT_HAS_TILE | BIT_HAS_X | BIT_HAS_Y | BIT_HAS_NAME2
        )
    header.flags |= BIT_PAIRED_END
    _set_read_length_bytes(header, int(block.seq_lens().max(initial=0)))
    return header


def _set_read_length_bytes(header: RfqHeader, max_len: int) -> None:
    # keep the reference's dead =4 branch (rfqcodec.cpp:48-53)
    if max_len > 65535:
        header.read_length_bytes = 4
    if max_len > 255:
        header.read_length_bytes = 2
    else:
        header.read_length_bytes = 1


def _name2_bytes(block: ReadBlock, meta: dict, i: int) -> bytes:
    s = int(meta["name2_start"][i])
    return block.name_flat[s : s + int(meta["name2_len"][i])].tobytes()


def _pe_interleave_support(
    block: ReadBlock, meta: dict, all_illumina: bool
) -> tuple[bool, int, int]:
    """Reference rfqcodec.cpp:69-122: support iff all reads are Illumina and
    every pair's name2s differ at exactly the position/char fixed by pair 0."""
    if not all_illumina:
        return False, 0, 0
    n2_0 = _name2_bytes(block, meta, 0)
    n2_1 = _name2_bytes(block, meta, 1)
    diff_pos, diff_char = 0, 0
    if len(n2_0) != len(n2_1):
        return False, 0, 0
    for p in range(len(n2_0)):
        if n2_0[p] != n2_1[p]:
            diff_pos, diff_char = p, n2_1[p]
            break

    lens = meta["name2_len"]
    ok = True
    if np.all(lens == lens[0]):
        L = int(lens[0])
        mat = gather_slices(
            block.name_flat, meta["name2_start"], lens
        ).reshape(block.n, L)
        even = mat[0::2].copy()
        if diff_char != 0 and diff_pos < L:
            even[:, diff_pos] = diff_char
        ok = bool((even == mat[1::2]).all())
    else:
        for p in range(block.n // 2):
            a = bytearray(_name2_bytes(block, meta, 2 * p))
            b = _name2_bytes(block, meta, 2 * p + 1)
            if len(a) < diff_pos:
                ok = False
                break
            if diff_char != 0 and diff_pos < len(a):
                a[diff_pos] = diff_char
            if bytes(a) != b:
                ok = False
                break
    return ok, diff_pos, diff_char


# ---------------------------------------------------------------------------
# PE overlap search (reference rfqcodec.cpp:1391-1438), hash-accelerated
# ---------------------------------------------------------------------------


def _overlap_pairs(r1: np.ndarray, r2: np.ndarray) -> np.ndarray:
    """First exact overlap per pair: +o forward (r1 suffix == r2 prefix),
    -o backward, 0 none. r1: (p, L1), r2: (p, L2), both uint8; r2 already
    reverse-complemented."""
    p, L1 = r1.shape
    L2 = r2.shape[1]
    minlen = min(L1, L2)
    out = np.zeros(p, dtype=np.int64)
    if minlen < MIN_OVERLAP or p == 0:
        return out
    from . import _native

    if _native.available():
        return _native.overlap_pairs(r1, r2)

    def first_candidate(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """min o in [12, minlen] with hash(a[:, La-o:]) == hash(b[:, :o])."""
        rows, La = a.shape
        h_suf = np.zeros(rows, dtype=np.uint64)
        h_pre = np.zeros(rows, dtype=np.uint64)
        powv = np.uint64(1)
        first = np.zeros(rows, dtype=np.int64)
        au = a.astype(np.uint64)
        bu = b.astype(np.uint64)
        with np.errstate(over="ignore"):
            for o in range(1, minlen + 1):
                h_suf = h_suf + au[:, La - o] * powv
                h_pre = h_pre * _HASH_BASE + bu[:, o - 1]
                powv = powv * _HASH_BASE
                if o >= MIN_OVERLAP:
                    hit = (first == 0) & (h_suf == h_pre)
                    if hit.any():
                        first[hit] = o
        return first

    def verify(a: np.ndarray, b: np.ndarray, o: np.ndarray) -> np.ndarray:
        La = a.shape[1]
        cols = np.arange(minlen, dtype=np.int64)
        valid = cols[None, :] < o[:, None]
        c1 = np.clip(La - o[:, None] + cols[None, :], 0, La - 1)
        eq = (np.take_along_axis(a, c1, axis=1) == b[:, :minlen]) | ~valid
        return eq.all(axis=1) & (o > 0)

    fwd = first_candidate(r1, r2)
    okf = verify(r1, r2, fwd)
    out[okf] = fwd[okf]
    todo = ~okf
    # hash collision at the first candidate (astronomically rare): exact scalar
    collide = todo & (fwd > 0)
    remaining = np.flatnonzero(todo & ~collide)
    if remaining.size:
        bwd = first_candidate(r2[remaining], r1[remaining])
        okb = verify(r2[remaining], r1[remaining], bwd)
        out[remaining[okb]] = -bwd[okb]
        collide_b = np.zeros(p, dtype=bool)
        collide_b[remaining[~okb & (bwd > 0)]] = True
        collide |= collide_b
    for i in np.flatnonzero(collide):
        out[i] = oracle.overlap(r1[i].tobytes(), r2[i].tobytes())
    return out


def _overlap_ragged(
    seq_flat: np.ndarray, off: np.ndarray, odd_flat: np.ndarray, odd_off: np.ndarray
) -> np.ndarray:
    """Scalar fallback for variable-length pairs."""
    n_pairs = (off.shape[0] - 1) // 2
    out = np.zeros(n_pairs, dtype=np.int64)
    for pidx in range(n_pairs):
        r1 = seq_flat[off[2 * pidx] : off[2 * pidx + 1]].tobytes()
        r2 = odd_flat[odd_off[pidx] : odd_off[pidx + 1]].tobytes()
        out[pidx] = oracle.overlap(r1, r2)
    return out


# ---------------------------------------------------------------------------
# chunk encode
# ---------------------------------------------------------------------------


def _all_same_content(flat, starts, lens) -> bool:
    """All slices identical (requires equal lens, checked by caller)."""
    n = starts.shape[0]
    L = int(lens[0])
    if L == 0:
        return True
    if _native.available():
        return _native.all_same_slices(flat, starts, L)
    mat = gather_slices(flat, starts, np.full(n, L, dtype=np.int64)).reshape(n, L)
    return bool((mat == mat[0]).all())


class ChunkAnalysis:
    """Host-side pass-1 products shared by the host and device engines:
    name metadata, the all-same predicates, and PE interleave viability
    (reference rfqcodec.cpp:171-287). Slots only — this is built once per
    chunk on the hot path."""

    __slots__ = (
        "meta", "seq_lens", "name1_lens", "name2_lens", "strand_lens",
        "lane", "tile", "xs", "ys", "read_len_same", "name1_len_same",
        "name2_len_same", "strand_len_same", "lane_same", "tile_same",
        "name1_same", "strand_same", "name2_same", "can_interleave",
        "encode_overlap",
    )


def analyze_chunk(header: RfqHeader, block: ReadBlock, is_pe: bool) -> ChunkAnalysis:
    a = ChunkAnalysis()
    a.meta = meta = parse_names(block.name_flat, block.name_off)
    a.seq_lens = seq_lens = block.seq_lens().astype(np.int64)
    a.name1_lens = name1_lens = meta["name1_len"]
    a.name2_lens = name2_lens = meta["name2_len"]
    a.strand_lens = strand_lens = np.diff(block.strand_off).astype(np.int64)
    a.lane = lane = meta["lane"].astype(np.int64)
    a.tile = tile = meta["tile"].astype(np.int64)
    a.xs = meta["x"].astype(np.int64)
    a.ys = meta["y"].astype(np.int64)

    a.read_len_same = bool((seq_lens == seq_lens[0]).all())
    a.name1_len_same = name1_len_same = bool((name1_lens == name1_lens[0]).all())
    a.name2_len_same = bool((name2_lens == name2_lens[0]).all())
    a.strand_len_same = strand_len_same = bool(
        (strand_lens == strand_lens[0]).all()
    )
    a.lane_same = bool((lane == lane[0]).all())
    a.tile_same = bool((tile == tile[0]).all())
    a.name1_same = name1_len_same and _all_same_content(
        block.name_flat, meta["name1_start"], name1_lens
    )
    a.strand_same = strand_len_same and _all_same_content(
        block.strand_flat, block.strand_off[:-1], strand_lens
    )

    can_interleave = is_pe and header.support_interleaved
    a.name2_same, a.can_interleave = _compute_name2_same_and_interleave(
        header, block, meta, can_interleave
    )
    a.encode_overlap = a.can_interleave and header.encode_pe_by_overlap()
    return a


def encode_chunk(header: RfqHeader, block: ReadBlock, is_pe: bool = False) -> RfqChunk | None:
    s = block.n
    if s == 0:
        return None

    a = analyze_chunk(header, block, is_pe)
    seq_lens = a.seq_lens
    can_interleave = a.can_interleave

    # ---- transformed seq/qual (odd reads revcomped when interleaving) ----
    # Native fast route: instead of materializing a full revcomp'd copy
    # of the chunk (tseq) and gathering (pairs, L) overlap matrices plus
    # the stored-span concat out of it, revcomp the odd reads ONCE into a
    # compact buffer; overlap scans run strided over the reader's
    # interleaved layout + that buffer, and the stored-span concat pulls
    # even spans from seq_flat / odd spans from the compact buffer. Same
    # bytes, ~2.3x less memory traffic on the seq side.
    odd_rc = odd_rc_off = None
    even_src = even_seq_starts = None
    off64 = block.seq_off.astype(np.int64)
    if can_interleave:
        from . import _native

        sp = getattr(block, "pe_spans", None)
        if _native.available() and sp is not None:
            # lazy-span route: sources are the reader's mapped input
            # windows; the reader guaranteed qual layout == seq layout
            tseq = None
            odd_lens = seq_lens[1::2]
            odd_rc_off = lens_to_offsets(odd_lens)
            odd_rc = np.empty(int(odd_rc_off[-1]), dtype=np.uint8)
            _native.reverse_slices(
                sp.src2, sp.seq_starts2, odd_rc, odd_rc_off[:-1],
                odd_lens, _COMP,
            )
            tqual = np.empty(int(block.qual_off[-1]), dtype=np.uint8)
            _native.copy_slices(
                sp.src1, sp.qual_starts1, tqual, off64[:-1][0::2],
                seq_lens[0::2],
            )
            _native.reverse_slices(
                sp.src2, sp.qual_starts2, tqual, off64[:-1][1::2],
                odd_lens, None,
            )
            even_src = sp.src1
            even_seq_starts = sp.seq_starts1
        elif _native.available() and np.array_equal(
            block.qual_off, block.seq_off
        ):
            tseq = None
            odd_starts = off64[:-1][1::2]
            odd_lens = seq_lens[1::2]
            odd_rc_off = lens_to_offsets(odd_lens)
            odd_rc = np.empty(int(odd_rc_off[-1]), dtype=np.uint8)
            _native.reverse_slices(
                block.seq_flat, odd_starts, odd_rc, odd_rc_off[:-1],
                odd_lens, _COMP,
            )
            # tqual: even quals copied, odd quals reversed, in place of
            # the full-copy-then-reverse
            tqual = np.empty(len(block.qual_flat), dtype=np.uint8)
            _native.copy_slices(
                block.qual_flat, off64[:-1][0::2], tqual, off64[:-1][0::2],
                seq_lens[0::2],
            )
            _native.reverse_slices(
                block.qual_flat, odd_starts, tqual, odd_starts, odd_lens,
                None,
            )
            even_src = block.seq_flat
            even_seq_starts = off64[:-1][0::2]
        else:
            tseq, tqual = _revcomp_odd(block, seq_lens)
    else:
        tseq, tqual = block.seq_flat, block.qual_flat

    encode_overlap = a.encode_overlap
    ov = np.zeros(s // 2 if is_pe else 0, dtype=np.int64)
    if can_interleave and encode_overlap:
        even_l = seq_lens[0::2]
        odd_l = seq_lens[1::2]
        if s >= 2 and bool((even_l == even_l[0]).all()) and bool(
            (odd_l == odd_l[0]).all()
        ):
            if odd_rc is not None:
                from . import _native

                if min(int(even_l[0]), int(odd_l[0])) >= MIN_OVERLAP:
                    ov = _native.overlap_pairs_starts(
                        even_src, even_seq_starts, odd_rc, odd_rc_off[:-1],
                        int(even_l[0]), int(odd_l[0]),
                    )
                # else: ov stays all-zero (mirrors _overlap_pairs)
            else:
                off = block.seq_off
                r1 = gather_slices(
                    tseq, off[:-1][0::2],
                    np.full(s // 2, even_l[0], dtype=np.int64),
                ).reshape(s // 2, int(even_l[0]))
                r2 = gather_slices(
                    tseq, off[:-1][1::2],
                    np.full(s // 2, odd_l[0], dtype=np.int64),
                ).reshape(s // 2, int(odd_l[0]))
                ov = _overlap_pairs(r1, r2)
        else:
            if odd_rc is not None:
                odd_flat, odd_off = odd_rc, odd_rc_off
            else:
                odd_off = lens_to_offsets(odd_l)
                odd_flat = gather_slices(
                    tseq, block.seq_off[:-1][1::2], odd_l
                )
            ov = _overlap_ragged(block.seq_flat, block.seq_off, odd_flat, odd_off)
        # shift clamp (reference rfqcodec.cpp:379-382)
        shifted = ov + header.overlap_shift
        ov = np.where((shifted > 127) | (shifted < -127), 0, ov)

    # ---- stored sequence pieces (overlap elision) ----
    starts = block.seq_off[:-1].astype(np.int64).copy()
    stored = seq_lens.copy()
    fwd = None
    if encode_overlap and can_interleave and ov.size:
        fwd = np.maximum(ov, 0)
        starts[1::2] += fwd
        stored[1::2] -= np.abs(ov)
    if odd_rc is not None:
        from . import _native

        out_off = lens_to_offsets(stored)
        seq_concat = np.empty(int(out_off[-1]), dtype=np.uint8)
        _native.copy_slices(
            even_src, even_seq_starts, seq_concat, out_off[:-1][0::2],
            stored[0::2],
        )
        odd_src = odd_rc_off[:-1] + fwd if fwd is not None else odd_rc_off[:-1]
        _native.copy_slices(
            odd_rc, odd_src, seq_concat, out_off[:-1][1::2], stored[1::2]
        )
    else:
        seq_concat = gather_slices(tseq, starts, stored)
    qual_concat = tqual

    seq_encoded = K.pack_2bit(seq_concat)
    if header.dont_encode_qual():
        qual_encoded = qual_concat
    elif header.encode_qual_by_col():
        qual_encoded = K.encode_qual_by_col(
            qual_concat, header.normal_qual_buf(), header.major_qual()
        )
    else:
        qual_encoded = np.frombuffer(
            oracle.encode_qual_runlen(header, qual_concat.tobytes()), dtype=np.uint8
        )

    npos_buf = np.empty(0, dtype=np.uint8)
    if header.encode_n_pos():
        npos_buf = K.encode_positions_of(seq_concat, ord("N"))

    return assemble_chunk(
        header, block, a, ov, seq_encoded.tobytes(), qual_encoded.tobytes(),
        npos_buf.tobytes()
    )


def assemble_chunk(
    header: RfqHeader,
    block: ReadBlock,
    a: ChunkAnalysis,
    ov: np.ndarray,
    seq_bytes: bytes,
    qual_bytes: bytes,
    npos_bytes: bytes,
    x_bytes: bytes | None = None,
    y_bytes: bytes | None = None,
) -> RfqChunk:
    """Container assembly from encoded streams (reference
    rfqcodec.cpp:433-585): flags, length buffers, name/strand buffers,
    coordinate buffers (host-coded unless x_bytes/y_bytes are passed in by
    the device engine), final mSize accounting. Pure byte bookkeeping —
    stays on host by design."""
    s = block.n
    meta = a.meta
    seq_lens = a.seq_lens
    name1_lens = a.name1_lens
    name2_lens = a.name2_lens
    strand_lens = a.strand_lens
    lane, tile, xs, ys = a.lane, a.tile, a.xs, a.ys
    can_interleave = a.can_interleave
    encode_overlap = a.encode_overlap
    read_len_same = a.read_len_same
    name1_len_same = a.name1_len_same

    chunk = RfqChunk(header)
    chunk.reads = s
    if can_interleave:
        chunk.flags |= BIT_PE_INTERLEAVED
    for flag, val in (
        (BIT_READ_LEN_SAME, read_len_same),
        (BIT_NAME1_LEN_SAME, name1_len_same),
        (BIT_NAME2_LEN_SAME, a.name2_len_same),
        (BIT_STRAND_LEN_SAME, a.strand_len_same),
        (BIT_STRAND_SAME, a.strand_same),
        (BIT_LANE_SAME, a.lane_same),
        (BIT_TILE_SAME, a.tile_same),
        (BIT_NAME1_SAME, a.name1_same),
        (BIT_NAME2_SAME, a.name2_same),
    ):
        if val:
            chunk.flags |= flag

    chunk.seq_buf_size = len(seq_bytes)
    chunk.qual_buf_size = len(qual_bytes)

    nb = header.read_length_bytes
    if read_len_same:
        chunk.read_len_buf = (int(seq_lens[0]) & ((1 << (8 * nb)) - 1)).to_bytes(
            nb, "little"
        )
        chunk.read_len_buf_size = nb
    else:
        dtype = {1: "<u1", 2: "<u2", 4: "<u4"}[nb]
        chunk.read_len_buf = seq_lens.astype(dtype).tobytes()
        chunk.read_len_buf_size = nb * s

    def len_buf(lens, same, first):
        if same:
            return bytes([int(first) & 0xFF]), 1
        return (lens & 0xFF).astype(np.uint8).tobytes(), s

    chunk.name1_len_buf, chunk.name1_len_buf_size = len_buf(
        name1_lens, name1_len_same, name1_lens[0]
    )
    chunk.name2_len_buf, chunk.name2_len_buf_size = len_buf(
        name2_lens, a.name2_len_same, name2_lens[0]
    )
    chunk.strand_len_buf, chunk.strand_len_buf_size = len_buf(
        strand_lens, a.strand_len_same, strand_lens[0]
    )

    half = s // 2 if can_interleave else s
    if a.lane_same:
        chunk.lane_buf = bytes([int(lane[0]) & 0xFF])
        chunk.lane_buf_size = 1
    else:
        lv = lane[0::2] if can_interleave else lane
        chunk.lane_buf = (lv & 0xFF).astype(np.uint8).tobytes()
        chunk.lane_buf_size = half
    if a.tile_same:
        chunk.tile_buf = (int(tile[0]) & 0xFFFF).to_bytes(2, "little")
        # reference quirk: tile byte count lands in the lane size field
        chunk.lane_buf_size = 2
    else:
        tv = tile[0::2] if can_interleave else tile
        chunk.tile_buf = (tv & 0xFFFF).astype("<u2").tobytes()
        chunk.lane_buf_size = 2 * half
    chunk.tile_buf_size = 0

    if header.has_x():
        if x_bytes is None:
            xv = xs[0::2] if can_interleave else xs
            x_bytes = K.encode_coords(xv).tobytes()
        chunk.x_buf = x_bytes
        chunk.x_buf_size = len(chunk.x_buf)
    if header.has_y():
        if y_bytes is None:
            yv = ys[0::2] if can_interleave else ys
            y_bytes = K.encode_coords(yv).tobytes()
        chunk.y_buf = y_bytes
        chunk.y_buf_size = len(chunk.y_buf)

    if a.name1_same:
        s0 = int(meta["name1_start"][0])
        chunk.name1_buf = block.name_flat[s0 : s0 + int(name1_lens[0])].tobytes()
        chunk.name1_buf_size = int(name1_lens[0])
    else:
        chunk.name1_buf = gather_slices(
            block.name_flat, meta["name1_start"], name1_lens
        ).tobytes()
        chunk.name1_buf_size = len(chunk.name1_buf)

    if a.name2_same:
        s0 = int(meta["name2_start"][0])
        chunk.name2_buf = block.name_flat[s0 : s0 + int(name2_lens[0])].tobytes()
        chunk.name2_buf_size = int(name2_lens[0])
    else:
        chunk.name2_buf = gather_slices(
            block.name_flat, meta["name2_start"], name2_lens
        ).tobytes()
        chunk.name2_buf_size = len(chunk.name2_buf)

    if a.strand_same:
        s0 = int(block.strand_off[0])
        chunk.strand_buf = block.strand_flat[
            s0 : s0 + int(strand_lens[0])
        ].tobytes()
        chunk.strand_buf_size = int(strand_lens[0])
    else:
        chunk.strand_buf = block.strand_flat.tobytes()
        chunk.strand_buf_size = len(chunk.strand_buf)

    chunk.seq_buf = seq_bytes
    chunk.qual_buf = qual_bytes
    if encode_overlap:
        chunk.overlap_buf = (
            ((ov + header.overlap_shift) & 0xFF).astype(np.uint8).tobytes()
            if can_interleave
            else bytes(s // 2)
        )
    if header.encode_n_pos():
        chunk.npos_buf = npos_bytes
        chunk.npos_buf_size = len(chunk.npos_buf)

    chunk.calc_total_buf_size()
    return chunk


def _compute_name2_same_and_interleave(
    header: RfqHeader, block: ReadBlock, meta: dict, can_interleave: bool
) -> tuple[bool, bool]:
    """Reference rfqcodec.cpp:233-270: the sequential loop degrades
    can_interleave at the first inconsistent pair; which odd reads feed the
    name2Same predicate depends on where/why degradation happened."""
    n = block.n
    lens = meta["name2_len"].astype(np.int64)
    diff_pos, diff_char = header.name2_diff_pos, header.name2_diff_char

    if _native.available():
        eq_first, name2_ok = _native.name2_predicates(
            block.name_flat, meta["name2_start"], lens, diff_pos,
            diff_char,
        )
        if not can_interleave:
            return bool(eq_first.all()), False
    else:
        n2_0 = _name2_bytes(block, meta, 0)
        len0 = len(n2_0)

        eq_first = np.zeros(n, dtype=bool)
        same_len_as_first = lens == len0
        if same_len_as_first.any() and len0 > 0:
            idxs = np.flatnonzero(same_len_as_first)
            mat = gather_slices(
                block.name_flat,
                meta["name2_start"][idxs],
                np.full(idxs.shape[0], len0, dtype=np.int64),
            ).reshape(-1, len0)
            first = np.frombuffer(n2_0, dtype=np.uint8)
            eq_first[idxs] = (mat == first).all(axis=1)
        elif len0 == 0:
            eq_first = lens == 0

        if not can_interleave:
            return bool(eq_first.all()), False

        # pair-level consistency
        pairs = n // 2
        name2_ok = np.zeros(pairs, dtype=bool)
        if bool((lens == lens[0]).all()):
            L = int(lens[0])
            if L == 0:
                # oracle.py:513-516 substitutes only when diff_pos <
                # len(name2): empty name2s always compare equal
                name2_ok[:] = True
            else:
                mat = gather_slices(
                    block.name_flat, meta["name2_start"], lens
                ).reshape(n, L)
                even = mat[0::2].copy()
                if diff_char != 0 and diff_pos < L:
                    even[:, diff_pos] = diff_char
                name2_ok = (even == mat[1::2]).all(axis=1)
        else:
            for pidx in range(pairs):
                a = bytearray(_name2_bytes(block, meta, 2 * pidx))
                b = _name2_bytes(block, meta, 2 * pidx + 1)
                if diff_char != 0 and diff_pos < len(a):
                    a[diff_pos] = diff_char
                name2_ok[pidx] = bytes(a) == b

    lane = meta["lane"]
    tile = meta["tile"]
    xs = meta["x"]
    ys = meta["y"]
    xy_ok = (
        (lane[0::2] == lane[1::2])
        & (tile[0::2] == tile[1::2])
        & (xs[0::2] == xs[1::2])
        & (ys[0::2] == ys[1::2])
    )

    bad = ~(name2_ok & xy_ok)
    if not bad.any():
        # never degraded: odd reads never enter the name2Same predicate
        return bool(eq_first[0::2].all()), True

    p_star = int(np.argmax(bad))
    via_name2 = not bool(name2_ok[p_star])
    # odd reads checked from the degradation read onward
    first_checked_odd = p_star if via_name2 else p_star + 1
    name2_same = bool(eq_first[0::2].all()) and bool(
        eq_first[1::2][first_checked_odd:].all()
    )
    return name2_same, False


def _revcomp_odd(block: ReadBlock, seq_lens: np.ndarray):
    """Reverse-complement odd reads' seqs and reverse their quals, in the
    flat layout (even reads unchanged)."""
    from . import _native

    n = block.n
    off = block.seq_off.astype(np.int64)
    odd_starts = off[:-1][1::2]
    odd_lens = seq_lens[1::2]
    if _native.available():
        src_seq = np.ascontiguousarray(block.seq_flat)
        src_qual = np.ascontiguousarray(block.qual_flat)
        tseq = src_seq.copy()
        tqual = src_qual.copy()
        _native.reverse_slices(src_seq, odd_starts, tseq, odd_starts, odd_lens, _COMP)
        _native.reverse_slices(src_qual, odd_starts, tqual, odd_starts, odd_lens, None)
        return tseq, tqual
    idx = np.arange(int(seq_lens.sum()), dtype=np.int64)
    rid = np.repeat(np.arange(n, dtype=np.int64), seq_lens)
    local = idx - off[rid]
    is_odd = (rid & 1) == 1
    src = np.where(is_odd, off[rid] + (seq_lens[rid] - 1 - local), idx)
    tseq = block.seq_flat[src]
    tseq = np.where(is_odd, _COMP[tseq], tseq).astype(np.uint8)
    tqual = block.qual_flat[src]
    return tseq, tqual


# ---------------------------------------------------------------------------
# chunk decode
# ---------------------------------------------------------------------------


def decode_chunk(header: RfqHeader, chunk: RfqChunk) -> ReadBlock:
    n = chunk.reads
    if n == 0:
        return ReadBlock.from_reads([])
    pe_interleaved = bool(chunk.flags & BIT_PE_INTERLEAVED)
    encode_overlap = pe_interleaved and header.encode_pe_by_overlap()

    read_lens = chunk.read_lengths().astype(np.int64)
    seq_len = int(read_lens.sum())
    seq_off = lens_to_offsets(read_lens)

    seq = K.unpack_2bit(np.frombuffer(chunk.seq_buf, dtype=np.uint8), seq_len)

    if header.encode_n_pos():
        pos = K.decode_positions(np.frombuffer(chunk.npos_buf, dtype=np.uint8))
        seq[pos[pos < seq_len]] = ord("N")

    p_starts = p_lens = None
    if encode_overlap:
        ovb = np.frombuffer(chunk.overlap_buf, dtype=np.int8).astype(np.int64)
        ov = ovb - header.overlap_shift
        stored = read_lens.copy()
        stored[1::2] -= np.abs(ov)
        src_off = lens_to_offsets(stored)
        # three pieces per read: [R1-tail copy][stored span][R1-head copy]
        p_starts = np.zeros(3 * n, dtype=np.int64)
        p_lens = np.zeros(3 * n, dtype=np.int64)
        p_starts[0::3][1::2] = src_off[:-1][1::2] - np.maximum(ov, 0)
        p_lens[0::3][1::2] = np.maximum(ov, 0)
        p_starts[1::3] = src_off[:-1]
        p_lens[1::3] = stored
        bwd = np.maximum(-ov, 0)
        p_starts[2::3][1::2] = src_off[:-1][0::2]
        p_lens[2::3][1::2] = bwd

    from . import _native

    fused_restore = pe_interleaved and _native.available()
    if encode_overlap and not fused_restore:
        seq = gather_slices(seq, p_starts, p_lens)

    if header.dont_encode_qual():
        qual = np.full(seq_len, header.major_qual(), dtype=np.uint8)
        raw = np.frombuffer(chunk.qual_buf, dtype=np.uint8)
        m = min(raw.shape[0], seq_len)
        qual[:m] = raw[:m]
    elif header.encode_qual_by_col():
        qual = K.decode_qual_by_col(
            np.frombuffer(chunk.qual_buf, dtype=np.uint8),
            header.normal_qual_buf(),
            header.major_qual(),
            seq_len,
        )
    else:
        qual = K.decode_qual_runlen(
            np.frombuffer(chunk.qual_buf, dtype=np.uint8),
            header.bit2qual,
            header.major_qual_num_bits(),
            header.normal_qual_num_bits,
            seq_len,
        )

    if fused_restore:
        # one write of the chunk instead of three: the overlap expansion
        # gather, the full-copy, and the odd-row reverse collapse into a
        # piecewise scatter that emits odd rows reverse-complemented
        # (rc(p3)+rc(p2)+rc(p1) == rc of the transformed row). The
        # N-from-quality patch moves AFTER the restore: both arrays
        # undergo the same per-row permutation and comp('N') == 'N', so
        # the patched byte set is identical.
        even_starts = seq_off[:-1][0::2]
        odd_starts = seq_off[:-1][1::2]
        even_lens = read_lens[0::2]
        odd_lens = read_lens[1::2]
        restored = np.empty(seq_len, dtype=np.uint8)
        if encode_overlap:
            _native.scatter_pieces_rc(
                seq, p_starts, p_lens, restored, seq_off, _COMP
            )
        else:
            _native.copy_slices(
                seq, even_starts, restored, even_starts, even_lens
            )
            _native.reverse_slices(
                seq, odd_starts, restored, odd_starts, odd_lens, _COMP
            )
        seq = restored
        qrestored = np.empty(seq_len, dtype=np.uint8)
        _native.copy_slices(
            qual, even_starts, qrestored, even_starts, even_lens
        )
        _native.reverse_slices(
            qual, odd_starts, qrestored, odd_starts, odd_lens, None
        )
        qual = qrestored
        if not header.encode_n_pos() and header.n_base_qual < 128:
            seq[qual == header.n_base_qual] = ord("N")
        return assemble_block(header, chunk, n, read_lens, seq_off, seq, qual)

    if not header.encode_n_pos() and header.n_base_qual < 128:
        seq[qual == header.n_base_qual] = ord("N")

    if pe_interleaved:
        # revcomp odd reads back to their original orientation
        # (no-native fallback; the native route returned above)
        idx = np.arange(seq_len, dtype=np.int64)
        rid = np.repeat(np.arange(n, dtype=np.int64), read_lens)
        local = idx - seq_off[rid]
        is_odd = (rid & 1) == 1
        src = np.where(
            is_odd, seq_off[rid] + (read_lens[rid] - 1 - local), idx
        )
        seq2 = seq[src]
        seq = np.where(is_odd, _COMP[seq2], seq2).astype(np.uint8)
        qual = np.ascontiguousarray(qual)[src]

    return assemble_block(header, chunk, n, read_lens, seq_off, seq, qual)


def assemble_block(
    header: RfqHeader,
    chunk: RfqChunk,
    n: int,
    read_lens: np.ndarray,
    seq_off: np.ndarray,
    seq: np.ndarray,
    qual: np.ndarray,
) -> ReadBlock:
    """ReadBlock assembly from decoded seq/qual (reference
    rfqcodec.cpp:1141-1231): name reconstruction from name1/lane/tile/x/y/
    name2 buffers, strand expansion. Shared by the host and device decode
    engines — string rebuild stays on host by design."""
    pe_interleaved = bool(chunk.flags & BIT_PE_INTERLEAVED)
    # ---- name reconstruction ----
    name1_flat, name1_starts, name1_lens = _expand_strings(
        chunk.name1_buf,
        chunk.name1_len_buf,
        n,
        bool(chunk.flags & BIT_NAME1_SAME),
        bool(chunk.flags & BIT_NAME1_LEN_SAME),
    )
    xy_num = n // 2 if pe_interleaved else n
    xy_idx = (np.arange(n) // 2) if pe_interleaved else np.arange(n)

    lane = tile = x = y = None
    if header.has_lane():
        lanes = np.frombuffer(chunk.lane_buf, dtype=np.uint8)
        if chunk.flags & BIT_LANE_SAME:
            lane = np.full(n, lanes[0], dtype=np.int64)
        else:
            lane = lanes[xy_idx].astype(np.int64)
    if header.has_tile():
        tiles = np.frombuffer(chunk.tile_buf, dtype="<u2")
        if chunk.flags & BIT_TILE_SAME:
            tile = np.full(n, tiles[0], dtype=np.int64)
        else:
            tile = tiles[xy_idx].astype(np.int64)
    if header.has_x():
        xv = K.decode_coords(np.frombuffer(chunk.x_buf, dtype=np.uint8), xy_num)
        x = xv[xy_idx]
    if header.has_y():
        yv = K.decode_coords(np.frombuffer(chunk.y_buf, dtype=np.uint8), xy_num)
        y = yv[xy_idx]

    name2_flat = name2_starts = name2_lens = None
    if header.has_name2():
        if chunk.flags & BIT_NAME2_SAME:
            base = bytearray(chunk.name2_buf[: chunk.name2_len_buf[0]])
            sub = bytearray(base)
            if (
                pe_interleaved
                and header.name2_diff_char != 0
                and header.name2_diff_pos < len(sub)
            ):
                sub[header.name2_diff_pos] = header.name2_diff_char
            name2_flat = np.frombuffer(bytes(base) + bytes(sub), dtype=np.uint8)
            L = len(base)
            name2_starts = np.zeros(n, dtype=np.int64)
            if pe_interleaved and header.name2_diff_char != 0:
                name2_starts[1::2] = L
            name2_lens = np.full(n, L, dtype=np.int64)
        else:
            name2_flat, name2_starts, name2_lens = _expand_strings(
                chunk.name2_buf,
                chunk.name2_len_buf,
                n,
                False,
                bool(chunk.flags & BIT_NAME2_LEN_SAME),
            )

    name_flat, name_off = build_names(
        n,
        name1_flat,
        name1_starts,
        name1_lens,
        lane,
        tile,
        x,
        y,
        name2_flat,
        name2_starts,
        name2_lens,
    )

    strand_flat, strand_starts, strand_lens = _expand_strings(
        chunk.strand_buf,
        chunk.strand_len_buf,
        n,
        bool(chunk.flags & BIT_STRAND_SAME),
        bool(chunk.flags & BIT_STRAND_LEN_SAME),
    )
    strand_out = gather_slices(strand_flat, strand_starts, strand_lens)

    return ReadBlock(
        n,
        name_flat,
        name_off,
        np.ascontiguousarray(seq),
        seq_off,
        strand_out,
        lens_to_offsets(strand_lens),
        np.ascontiguousarray(qual),
        seq_off.copy(),
    )


def _expand_strings(buf: bytes, len_buf: bytes, n: int, same: bool, len_same: bool):
    """Map the SAME/LEN_SAME buffer conventions to per-read (starts, lens)."""
    flat = np.frombuffer(buf, dtype=np.uint8)
    if same:
        L = len_buf[0]
        return flat, np.zeros(n, dtype=np.int64), np.full(n, L, dtype=np.int64)
    if len_same:
        L = len_buf[0]
        return (
            flat,
            np.arange(n, dtype=np.int64) * L,
            np.full(n, L, dtype=np.int64),
        )
    lens = np.frombuffer(len_buf, dtype=np.uint8).astype(np.int64)[:n]
    return flat, lens_to_offsets(lens)[:-1], lens


# ---------------------------------------------------------------------------
# list[FastqRead] adapters (pipeline/tests interface parity with the oracle)
# ---------------------------------------------------------------------------


def encode_chunk_reads(header, reads, is_pe=False):
    return encode_chunk(header, ReadBlock.from_reads(reads), is_pe)


def encode_chunk_pe_reads(header, pairs):
    reads = []
    for r1, r2 in pairs:
        reads.append(r1)
        reads.append(r2)
    return encode_chunk(header, ReadBlock.from_reads(reads), True)


def decode_chunk_reads(header, chunk):
    return decode_chunk(header, chunk).to_reads()
