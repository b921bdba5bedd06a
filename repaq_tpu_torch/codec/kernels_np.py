"""Vectorized (numpy) formulations of the .rfq token coders.

Each sequential byte coder of the reference is recast as array passes:
classification -> per-element byte counts -> exclusive prefix sum ->
scatter. The same formulations back the JAX/Pallas device kernels in
``repaq_tpu.ops``; these numpy versions are the host fast path and the
cross-check for the device path.

Exactness notes are inline; every coder is property-tested against the
scalar oracle in tests/test_vectorized.py.
"""

from __future__ import annotations

import numpy as np

from . import _native

# ---------------------------------------------------------------------------
# 2-bit base packing (reference rfqcodec.cpp:588-609, 832-853)
# ---------------------------------------------------------------------------

_BASE_VAL = np.zeros(256, dtype=np.uint8)
_BASE_VAL[ord("G")] = 0
_BASE_VAL[ord("A")] = 1
_BASE_VAL[ord("T")] = 2
_BASE_VAL[ord("C")] = 3
_BIT2_BASE = np.frombuffer(b"GATC", dtype=np.uint8)


def pack_2bit(seq: np.ndarray) -> np.ndarray:
    """seq: uint8 bases -> packed uint8, 4 bases/byte, low bits first."""
    if _native.available():
        return _native.pack_2bit(np.ascontiguousarray(seq))
    n = seq.shape[0]
    vals = _BASE_VAL[seq]
    pad = (-n) % 4
    if pad:
        vals = np.concatenate([vals, np.zeros(pad, dtype=np.uint8)])
    v = vals.reshape(-1, 4)
    return (v[:, 0] | (v[:, 1] << 2) | (v[:, 2] << 4) | (v[:, 3] << 6)).astype(
        np.uint8
    )


def unpack_2bit(buf: np.ndarray, length: int) -> np.ndarray:
    """packed uint8 -> bases; positions beyond 4*len(buf) are 'N' (the
    decoder prefill, reference rfqcodec.cpp:1088)."""
    if _native.available():
        return _native.unpack_2bit(np.ascontiguousarray(buf), length)
    out = np.full(length, ord("N"), dtype=np.uint8)
    avail = min(length, buf.shape[0] * 4)
    if avail == 0:
        return out
    b = buf[: (avail + 3) // 4]
    expanded = np.empty(b.shape[0] * 4, dtype=np.uint8)
    expanded[0::4] = b & 3
    expanded[1::4] = (b >> 2) & 3
    expanded[2::4] = (b >> 4) & 3
    expanded[3::4] = (b >> 6) & 3
    out[:avail] = _BIT2_BASE[expanded[:avail]]
    return out


# ---------------------------------------------------------------------------
# gap/run position stream (reference rfqcodec.cpp:625-710, 957-1007)
# ---------------------------------------------------------------------------


def encode_positions_of(data: np.ndarray, q: int) -> np.ndarray:
    """Gap/run stream for the positions of symbol q in data."""
    if _native.available():
        return _native.positions_encode(np.ascontiguousarray(data), q)
    return encode_positions(np.flatnonzero(data == q))


def encode_positions(positions: np.ndarray) -> np.ndarray:
    """Byte stream for sorted match positions.

    Sequential rule: maintaining last = previous match (init -1), a match is
    a run-continuation iff pos-last==1 AND pos>1 (reference
    rfqcodec.cpp:644); maximal runs emit one byte per 32 covered positions;
    everything else emits a 1/2/4-byte gap token for distance pos-last.
    """
    p = positions.astype(np.int64)
    n = p.shape[0]
    if n == 0:
        return np.empty(0, dtype=np.uint8)
    delta = np.empty(n, dtype=np.int64)
    delta[0] = p[0] + 1
    delta[1:] = np.diff(p)
    adj = (delta == 1) & (p > 1)

    # segment offsets within maximal runs of adjacent matches
    run_start = adj.copy()
    run_start[1:] &= ~adj[:-1]
    idx = np.arange(n, dtype=np.int64)
    start_idx = np.where(run_start, idx, -1)
    np.maximum.accumulate(start_idx, out=start_idx)
    off_in_run = np.where(adj, idx - start_idx, 0)

    # run length of the segment each adjacent element belongs to
    seg_id = np.cumsum(run_start)
    seg_len = np.bincount(seg_id[adj], minlength=int(seg_id[-1]) + 1) if adj.any() else None

    emits_run_byte = adj & (off_in_run % 32 == 0)
    gap = ~adj
    d1 = gap & (delta <= 128)
    d2 = gap & (delta > 128) & (delta <= (1 << 14))
    d4 = gap & (delta > (1 << 14))

    counts = np.zeros(n, dtype=np.int64)
    counts[d1] = 1
    counts[d2] = 2
    counts[d4] = 4
    counts[emits_run_byte] = 1
    out_off = np.zeros(n, dtype=np.int64)
    np.cumsum(counts[:-1], out=out_off[1:])
    total = int(out_off[-1] + counts[-1])
    out = np.zeros(total, dtype=np.uint8)

    if d1.any():
        out[out_off[d1]] = (delta[d1] - 1).astype(np.uint8)
    if d2.any():
        v = delta[d2] - 1
        o = out_off[d2]
        out[o] = ((v >> 8) | 0x80).astype(np.uint8)
        out[o + 1] = (v & 0xFF).astype(np.uint8)
    if d4.any():
        v = delta[d4] - 1
        o = out_off[d4]
        out[o] = ((v >> 24) | 0xE0).astype(np.uint8)
        out[o + 1] = ((v >> 16) & 0xFF).astype(np.uint8)
        out[o + 2] = ((v >> 8) & 0xFF).astype(np.uint8)
        out[o + 3] = (v & 0xFF).astype(np.uint8)
    if emits_run_byte.any():
        lens = seg_len[seg_id[emits_run_byte]]
        covered = np.minimum(32, lens - off_in_run[emits_run_byte])
        out[out_off[emits_run_byte]] = (0xC0 | (covered - 1)).astype(np.uint8)
    return out


def _token_starts(buf: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Indices of token starts given per-byte token length (if a token
    started there). Uses the native FSM scan when available, else a Python
    token walk."""
    if _native.available():
        return _native.token_starts(lens)
    starts = []
    i = 0
    n = buf.shape[0]
    while i < n:
        starts.append(i)
        i += int(lens[i])
    return np.array(starts, dtype=np.int64)


def _stream_token_lens(buf: np.ndarray) -> np.ndarray:
    lens = np.ones(buf.shape[0], dtype=np.int64)
    lens[(buf >= 0x80) & (buf < 0xC0)] = 2
    lens[buf >= 0xE0] = 4
    return lens


def decode_positions(buf: np.ndarray) -> np.ndarray:
    """Inverse of encode_positions: byte stream -> sorted match positions."""
    n = buf.shape[0]
    if n == 0:
        return np.empty(0, dtype=np.int64)
    if _native.available():
        return _native.positions_decode(np.ascontiguousarray(buf))
    starts = _token_starts(buf, _stream_token_lens(buf))
    b0 = buf[starts].astype(np.int64)
    is_gap1 = b0 < 0x80
    is_gap2 = (b0 >= 0x80) & (b0 < 0xC0)
    is_run = (b0 >= 0xC0) & (b0 < 0xE0)
    is_gap4 = b0 >= 0xE0

    npos_per_tok = np.where(is_run, (b0 & 0x1F) + 1, 1)
    dist = np.ones(starts.shape[0], dtype=np.int64)
    dist[is_gap1] = b0[is_gap1] + 1
    if is_gap2.any():
        s = starts[is_gap2]
        dist[is_gap2] = (((b0[is_gap2] & 0x3F) << 8) | buf[s + 1]) + 1
    if is_gap4.any():
        s = starts[is_gap4]
        dist[is_gap4] = (
            ((b0[is_gap4] & 0x1F) << 24)
            | (buf[s + 1].astype(np.int64) << 16)
            | (buf[s + 2].astype(np.int64) << 8)
            | buf[s + 3]
        ) + 1

    total = int(npos_per_tok.sum())
    deltas = np.ones(total, dtype=np.int64)
    first_idx = np.zeros(len(starts), dtype=np.int64)
    np.cumsum(npos_per_tok[:-1], out=first_idx[1:])
    deltas[first_idx] = dist  # run tokens have dist=1, matching their first step
    return np.cumsum(deltas) - 1


# ---------------------------------------------------------------------------
# quality by-column coder (reference rfqcodec.cpp:712-765, 1009-1047)
# ---------------------------------------------------------------------------


def encode_qual_by_col(
    qual: np.ndarray, normal_bins: np.ndarray, major_qual: int
) -> np.ndarray:
    """u32le per-bin lengths, per-bin gap/run streams, then escape records
    (char u8 + abs pos u32le) for out-of-table qualities."""
    if _native.available():
        return _native.qualcol_encode(
            np.ascontiguousarray(qual),
            np.ascontiguousarray(normal_bins, dtype=np.uint8),
            major_qual,
        )
    streams = []
    for q in normal_bins:
        streams.append(encode_positions(np.flatnonzero(qual == q)))
    lens = np.array([s.shape[0] for s in streams], dtype=np.uint32)

    in_table = np.zeros(256, dtype=bool)
    in_table[normal_bins] = True
    in_table[major_qual] = True
    esc_pos = np.flatnonzero(~in_table[qual])
    esc = np.empty(esc_pos.shape[0] * 5, dtype=np.uint8)
    if esc_pos.shape[0]:
        esc[0::5] = qual[esc_pos]
        p = esc_pos.astype(np.uint32)
        esc[1::5] = p & 0xFF
        esc[2::5] = (p >> 8) & 0xFF
        esc[3::5] = (p >> 16) & 0xFF
        esc[4::5] = (p >> 24) & 0xFF
    parts = [lens.view(np.uint8)] + streams + [esc]
    parts = [p for p in parts if p.size]
    if not parts:
        return np.empty(0, dtype=np.uint8)
    return np.concatenate(parts)


def decode_qual_runlen(
    buf: np.ndarray,
    bit2qual: np.ndarray,
    mq_bits: int,
    nq_bits: int,
    length: int,
) -> np.ndarray:
    """Vectorized legacy run-length quality decode (reference
    rfqcodec.cpp:919-955; byte-exact with oracle.decode_qual_runlen).
    Even bytes are major-qual runs (count in the high mq_bits' worth),
    odd bytes carry a normal-bin index in the low bits. The reference
    re-iterates the buffer when the counts fall short of the expected
    length; np.tile mirrors that."""
    if length <= 0:
        return np.zeros(0, dtype=np.uint8)
    b = buf.astype(np.uint16)
    is_norm = (b & 1).astype(bool)
    nq_mask = (1 << (8 - nq_bits)) - 1
    q = np.where(is_norm, b & nq_mask, 0)
    num = np.where(is_norm, b >> (8 - nq_bits),
                   b >> (8 - mq_bits)).astype(np.int64) + 1
    vals = bit2qual[q].astype(np.uint8)
    total = int(num.sum())
    if total == 0:
        raise ValueError("corrupt run-length quality stream")
    reps = -(-length // total)
    if reps > 1:
        vals = np.tile(vals, reps)
        num = np.tile(num, reps)
    return np.repeat(vals, num)[:length]


def qualcol_decode_counts(
    buf: np.ndarray, nbins: int
) -> tuple[int, int, int] | None:
    """Exact (tokens, positions, escape_records) of a by-col qual stream:
    the host-side cap pass for the device decode kernels (one cheap token
    walk over the COMPRESSED bytes — native FSM when available). Tight
    static caps keep the device kernel's compact spaces proportional to
    the stream, not the chunk. Returns None for a length-corrupt stream —
    callers MUST route such chunks to the host decoder, which raises the
    reference's error instead of masking to tiny caps."""
    if buf.shape[0] < 4 * nbins:
        return None  # corrupt: lens prefix itself is truncated
    lens = buf[: 4 * nbins].view("<u4").astype(np.int64)
    end = 4 * nbins + int(lens.sum())
    if end > buf.shape[0]:
        return None  # corrupt: bin streams overrun the buffer
    stream = buf[4 * nbins : end]
    if stream.shape[0] == 0:
        return 0, 0, (buf.shape[0] - end) // 5
    starts = _token_starts(stream, _stream_token_lens(stream))
    b0 = stream[starts].astype(np.int64)
    is_run = (b0 >= 0xC0) & (b0 < 0xE0)
    npos = int(np.where(is_run, (b0 & 0x1F) + 1, 1).sum())
    return int(starts.shape[0]), npos, (buf.shape[0] - end) // 5


def decode_qual_by_col(
    buf: np.ndarray, normal_bins: np.ndarray, major_qual: int, length: int
) -> np.ndarray:
    if _native.available():
        return _native.qualcol_decode(
            np.ascontiguousarray(buf),
            np.ascontiguousarray(normal_bins, dtype=np.uint8),
            major_qual,
            length,
        )
    qual = np.full(length, major_qual, dtype=np.uint8)
    nbins = normal_bins.shape[0]
    lens = buf[: 4 * nbins].view(np.uint32).astype(np.int64)
    consumed = 4 * nbins
    for q, ln in zip(normal_bins, lens):
        pos = decode_positions(buf[consumed : consumed + int(ln)])
        qual[pos] = q
        consumed += int(ln)
    rest = buf[consumed:]
    n_esc = rest.shape[0] // 5
    if n_esc:
        rest = rest[: n_esc * 5]
        chars = rest[0::5]
        pos = (
            rest[1::5].astype(np.int64)
            | (rest[2::5].astype(np.int64) << 8)
            | (rest[3::5].astype(np.int64) << 16)
            | (rest[4::5].astype(np.int64) << 24)
        )
        ok = pos < length
        qual[pos[ok]] = chars[ok]
    return qual


# ---------------------------------------------------------------------------
# coordinate coder (reference rfqcodec.cpp:1262-1389)
# ---------------------------------------------------------------------------


def encode_coords(values: np.ndarray) -> np.ndarray:
    """Tokens: repeat groups (1 byte per <=32 repeats), +1..64 delta
    (1 byte), 15-bit absolute (2 bytes), 21-bit absolute (3 bytes)."""
    if _native.available():
        return _native.coords_encode(values)
    v = values.astype(np.int64)
    n = v.shape[0]
    if n == 0:
        return np.empty(0, dtype=np.uint8)
    if int(v.max()) >= (1 << 21):
        from ..format.header import RfqFormatError

        raise RfqFormatError(
            "The X/Y coordinate cannot be larger than 2M, but we get: %d"
            % int(v[v >= (1 << 21)][0])
        )
    prev = np.empty(n, dtype=np.int64)
    prev[0] = 1000
    prev[1:] = v[:-1]
    diff = v - prev
    is_rep = diff == 0
    is_delta = (diff > 0) & (diff <= 64)
    is_abs2 = ~is_rep & ~is_delta & (v <= 32767)
    is_abs3 = ~is_rep & ~is_delta & (v > 32767)

    # repeat-group offsets (a byte is emitted by the element completing each
    # 32-group and by the group's last element if a partial group remains)
    rep_start = is_rep.copy()
    rep_start[1:] &= ~is_rep[:-1]
    idx = np.arange(n, dtype=np.int64)
    start_idx = np.where(rep_start, idx, -1)
    np.maximum.accumulate(start_idx, out=start_idx)
    off_in_rep = np.where(is_rep, idx - start_idx, 0)
    seg_id = np.cumsum(rep_start)
    seg_len = (
        np.bincount(seg_id[is_rep], minlength=int(seg_id[-1]) + 1)
        if is_rep.any()
        else None
    )

    k = off_in_rep + 1  # 1-based position within repeat group
    full32 = is_rep & (k % 32 == 0)
    if is_rep.any():
        L = seg_len[seg_id]
        is_last = is_rep & (k == L) & (L % 32 != 0)
    else:
        is_last = np.zeros(n, dtype=bool)

    counts = np.zeros(n, dtype=np.int64)
    counts[is_delta] = 1
    counts[is_abs2] = 2
    counts[is_abs3] = 3
    counts += full32.astype(np.int64) + is_last.astype(np.int64)
    out_off = np.zeros(n, dtype=np.int64)
    np.cumsum(counts[:-1], out=out_off[1:])
    total = int(out_off[-1] + counts[-1])
    out = np.zeros(total, dtype=np.uint8)

    if full32.any():
        out[out_off[full32]] = 0xC0 | 31
    if is_last.any():
        o = out_off[is_last] + full32[is_last].astype(np.int64)
        rem = seg_len[seg_id[is_last]] % 32
        out[o] = (0xC0 | (rem - 1)).astype(np.uint8)
    if is_delta.any():
        out[out_off[is_delta]] = ((diff[is_delta] - 1) | 0x80).astype(np.uint8)
    if is_abs2.any():
        o = out_off[is_abs2]
        out[o] = (v[is_abs2] >> 8).astype(np.uint8)
        out[o + 1] = (v[is_abs2] & 0xFF).astype(np.uint8)
    if is_abs3.any():
        o = out_off[is_abs3]
        out[o] = ((v[is_abs3] >> 16) | 0xE0).astype(np.uint8)
        out[o + 1] = ((v[is_abs3] >> 8) & 0xFF).astype(np.uint8)
        out[o + 2] = (v[is_abs3] & 0xFF).astype(np.uint8)
    return out


def _coord_token_lens(buf: np.ndarray) -> np.ndarray:
    lens = np.ones(buf.shape[0], dtype=np.int64)
    lens[buf < 0x80] = 2
    lens[buf >= 0xE0] = 3
    return lens


def decode_coords(buf: np.ndarray, num: int) -> np.ndarray:
    n = buf.shape[0]
    if n == 0:
        return np.zeros(num, dtype=np.int64)
    if _native.available():
        return _native.coords_decode(np.ascontiguousarray(buf), num)
    starts = _token_starts(buf, _coord_token_lens(buf))
    b0 = buf[starts].astype(np.int64)
    is_abs2 = b0 < 0x80
    is_delta = (b0 >= 0x80) & (b0 < 0xC0)
    is_rep = (b0 >= 0xC0) & (b0 < 0xE0)
    is_abs3 = b0 >= 0xE0

    vals_per_tok = np.where(is_rep, (b0 & 0x1F) + 1, 1)
    absval = np.zeros(len(starts), dtype=np.int64)
    if is_abs2.any():
        s = starts[is_abs2]
        absval[is_abs2] = (b0[is_abs2] << 8) | buf[s + 1]
    if is_abs3.any():
        s = starts[is_abs3]
        absval[is_abs3] = (
            ((b0[is_abs3] & 0x1F) << 16)
            | (buf[s + 1].astype(np.int64) << 8)
            | buf[s + 2]
        )
    delta = np.where(is_delta, (b0 & 0x3F) + 1, 0)

    # per-token value via segments between absolute tokens: value =
    # segment_base + cumulative delta within segment (repeats add 0).
    # The stream-initial segment has a virtual anchor with base 1000.
    is_abs = is_abs2 | is_abs3
    seg_start = is_abs.copy()
    seg_start[0] = True
    base = np.where(is_abs, absval, 0)
    base[0] = absval[0] if is_abs[0] else 1000
    cd = np.cumsum(delta)
    idx = np.arange(len(starts), dtype=np.int64)
    anchor = np.where(seg_start, idx, 0)
    np.maximum.accumulate(anchor, out=anchor)
    # cd just BEFORE the anchor token (anchors that are deltas only occur for
    # the virtual initial anchor, whose own delta must count)
    cd_anchor = cd[anchor] - delta[anchor]
    tok_val = base[anchor] + cd - cd_anchor
    values = np.repeat(tok_val, vals_per_tok)
    out = np.zeros(num, dtype=np.int64)
    m = min(num, values.shape[0])
    out[:m] = values[:m]
    return out
