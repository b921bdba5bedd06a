"""Vectorized Illumina name parsing and reconstruction.

``parse_names`` reproduces the reference state machine (reference
fastqmeta.cpp:22-80) event-for-event over a whole block at once, including
its overwrite behaviors for names with 4-6 colons followed by a space (see
repaq_tpu.meta for the scalar rendering and tests/test_vectorized.py for
the equivalence suite).
"""

from __future__ import annotations

import numpy as np

from ..util import c_atoi
from .blocks import gather_slices, lens_to_offsets, scatter_slices

_BIG = np.int64(1 << 60)

_WS = np.zeros(256, dtype=bool)
for _c in b" \t\n\v\f\r":
    _WS[_c] = True
_DIGIT = np.zeros(256, dtype=bool)
for _c in range(0x30, 0x3A):
    _DIGIT[_c] = True


def atoi_spans(flat: np.ndarray, starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """C atoi over [starts, ends) spans, vectorized column-wise.

    Spans that would overflow int64 (>=19 digits) fall back to the scalar
    c_atoi for exact saturate-then-truncate behavior.
    """
    n = starts.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    starts = starts.astype(np.int64)
    ends = np.minimum(ends.astype(np.int64), flat.shape[0])
    ends = np.maximum(ends, starts)
    from . import _native

    if _native.available():
        return _native.atoi_spans(np.ascontiguousarray(flat), starts, ends)
    maxlen = int((ends - starts).max(initial=0))
    acc = np.zeros(n, dtype=np.int64)
    sign = np.ones(n, dtype=np.int64)
    started = np.zeros(n, dtype=bool)  # past ws/sign, collecting digits
    done = np.zeros(n, dtype=bool)
    ndigits = np.zeros(n, dtype=np.int64)
    for j in range(min(maxlen, 24)):
        cur = starts + j
        valid = (cur < ends) & ~done
        if not valid.any():
            break
        c = flat[np.where(valid, cur, 0)]
        ws = _WS[c]
        dig = _DIGIT[c]
        plus = c == ord("+")
        minus = c == ord("-")
        # pre-start: ws skips; sign starts; digit starts; other -> done
        pre = valid & ~started
        take_sign = pre & (plus | minus)
        sign = np.where(take_sign & minus, -1, sign)
        started = started | (valid & (take_sign | (pre & dig)))
        done = done | (pre & ~ws & ~take_sign & ~dig)
        # collecting: digit accumulates, other -> done
        coll = valid & started & ~done & dig
        acc = np.where(coll, acc * 10 + (c - 0x30), acc)
        ndigits += coll
        done = done | (valid & started & ~dig & ~take_sign)
    out = acc * sign
    big = (ndigits >= 19) | ((ends - starts) > 24)
    if big.any():
        for i in np.flatnonzero(big):
            out[i] = c_atoi(flat[starts[i] : ends[i]].tobytes())
    # (int) cast of the int64 value
    return ((out & 0xFFFFFFFF) ^ (1 << 31)) - (1 << 31)


def parse_names(flat: np.ndarray, off: np.ndarray) -> dict:
    """Parse n names. Returns dict of per-read arrays:
    illumina, lane(u8-masked), tile(u16), x(u32), y(u32),
    name1_start/name1_len, name2_start/name2_len (absolute into flat)."""
    from . import _native

    if _native.available():
        # one tight pass per name (the numpy event algebra below is the
        # cross-checked fallback; both mirror meta.py exactly)
        m = _native.parse_names_batch(flat, off)
        return {
            "illumina": m[:, 0].astype(bool),
            "lane": m[:, 1],
            "tile": m[:, 2],
            "x": m[:, 3],
            "y": m[:, 4],
            "name1_start": m[:, 5],
            "name1_len": m[:, 6],
            "name2_start": m[:, 7],
            "name2_len": m[:, 8],
        }
    n = off.shape[0] - 1
    starts = off[:-1].astype(np.int64)
    ends = off[1:].astype(np.int64)

    colon_pos = np.flatnonzero(flat == ord(":"))
    space_pos = np.flatnonzero(flat == ord(" "))
    c_lo = np.searchsorted(colon_pos, starts)
    c_hi = np.searchsorted(colon_pos, ends)
    s_lo = np.searchsorted(space_pos, starts)

    def colon_k(k: int) -> np.ndarray:
        if colon_pos.shape[0] == 0:
            return np.full(n, _BIG, dtype=np.int64)
        idx = c_lo + (k - 1)
        ok = idx < c_hi
        return np.where(ok, colon_pos[np.where(ok, idx, 0)], _BIG)

    q3, q4, q5, q6, q7 = (colon_k(k) for k in (3, 4, 5, 6, 7))
    if space_pos.shape[0] == 0:
        sp = np.full(n, _BIG, dtype=np.int64)
    else:
        sp_ok = s_lo < space_pos.shape[0]
        sp = np.where(sp_ok, space_pos[np.where(sp_ok, s_lo, 0)], _BIG)
        sp = np.where(sp < ends, sp, _BIG)

    breakpos = np.minimum(sp, q7)
    illumina = (breakpos < ends) & (q4 < breakpos)

    # lane + coords start: overwritten by the space event in the 4-colon
    # region (reference fastqmeta.cpp:42-45 firing twice)
    space_in4 = (sp > q4) & (sp < q5)
    lane_s = np.where(space_in4, q4 + 1, q3 + 1)
    lane_e = np.where(space_in4, sp, q4)
    coords_start = lane_s

    # tile: q5 event, overwritten by a space in the 5-colon region
    space_in5 = (sp > q5) & (sp < q6)
    tile_fired = q5 < breakpos
    tile_s = np.where(space_in5, q5 + 1, q4 + 1)
    tile_e = np.where(space_in5, sp, q5)

    # x: only at an actual 6th colon
    x_fired = q6 < breakpos
    x_s, x_e = q5 + 1, q6

    # y: space in the 6-colon region, else the 7th colon event
    space_in6 = (sp > q6) & (sp < q7)
    y_fired = space_in6 | (q7 < sp)
    y_s = q6 + 1
    y_e = np.where(space_in6, sp, q7)

    zero = np.zeros(n, dtype=np.int64)

    def field(fired, s, e):
        s = np.where(illumina & fired, s, 0)
        e = np.where(illumina & fired, e, 0)
        return atoi_spans(flat, s, e)

    lane = field(illumina, lane_s, lane_e) & 0xFF
    tile = field(tile_fired, tile_s, tile_e) & 0xFFFF
    x = field(x_fired, np.full(n, 0) + x_s, x_e) & 0xFFFFFFFF
    y = field(y_fired, y_s, y_e) & 0xFFFFFFFF

    name1_start = starts
    name1_len = np.where(illumina, coords_start - 1 - starts, ends - starts)
    name2_start = np.where(illumina, breakpos, ends)
    name2_len = np.where(illumina, ends - breakpos, 0)

    return {
        "illumina": illumina,
        "lane": np.where(illumina, lane, 0),
        "tile": np.where(illumina, tile, 0),
        "x": np.where(illumina, x, 0),
        "y": np.where(illumina, y, 0),
        "name1_start": name1_start,
        "name1_len": name1_len,
        "name2_start": name2_start,
        "name2_len": name2_len,
    }


def _dec_len(v: np.ndarray) -> np.ndarray:
    """Decimal length of unsigned values (>=1)."""
    v = v.astype(np.int64)
    lens = np.ones(v.shape[0], dtype=np.int64)
    t = v // 10
    while np.any(t > 0):
        lens += t > 0
        t //= 10
    return lens


def build_names(
    n: int,
    name1_flat: np.ndarray,
    name1_starts: np.ndarray,
    name1_lens: np.ndarray,
    lane: np.ndarray | None,
    tile: np.ndarray | None,
    x: np.ndarray | None,
    y: np.ndarray | None,
    name2_flat: np.ndarray | None,
    name2_starts: np.ndarray | None,
    name2_lens: np.ndarray | None,
) -> tuple[np.ndarray, np.ndarray]:
    """Reassemble names: name1 [":"+lane][":"+tile][":"+x][":"+y][name2]
    (reference rfqcodec.cpp:1156-1231). Returns (flat, offsets)."""
    from . import _native

    if _native.available():
        lt = [None if a is None else a.astype(np.int64)
              for a in (lane, tile, x, y)]
        return _native.format_names(
            np.ascontiguousarray(name1_flat), name1_starts, name1_lens,
            lt[0], lt[1], lt[2], lt[3],
            None if name2_flat is None
            else np.ascontiguousarray(name2_flat),
            name2_starts, name2_lens, n,
        )
    total_len = name1_lens.astype(np.int64).copy()
    fields = []
    for arr in (lane, tile, x, y):
        if arr is not None:
            dl = _dec_len(arr)
            fields.append((arr.astype(np.int64), dl))
            total_len += 1 + dl
    if name2_lens is not None:
        total_len += name2_lens

    off = lens_to_offsets(total_len)
    out = np.empty(int(off[-1]), dtype=np.uint8)

    pos = off[:-1].copy()

    def put_slices(flat, starts, lens):
        nonlocal pos
        scatter_slices(flat, out, pos, lens, src_starts=starts)
        pos = pos + lens

    put_slices(name1_flat, name1_starts, name1_lens.astype(np.int64))
    for vals, dl in fields:
        out[pos] = ord(":")
        pos = pos + 1
        # right-aligned decimal digits: digit j (from most significant)
        maxd = int(dl.max(initial=1))
        digits = np.empty((n, maxd), dtype=np.uint8)
        t = vals.copy()
        for col in range(maxd - 1, -1, -1):
            digits[:, col] = (t % 10 + 0x30).astype(np.uint8)
            t //= 10
        # scatter only the significant digits (left-padded area skipped)
        dstarts = np.arange(n, dtype=np.int64) * maxd + (maxd - dl)
        scatter_slices(digits.reshape(-1), out, pos, dl, src_starts=dstarts)
        pos = pos + dl
    if name2_lens is not None:
        put_slices(name2_flat, name2_starts, name2_lens.astype(np.int64))
    return out, off
