"""Host (numpy) interleaved-rANS entropy coder — the exact oracle for the
device kernels in ops/rans_device.py and the engine behind the `.rfqz`
second-stage container (format/rfqz.py).

This replaces the reference's external `xz` subprocess stage (reference
main.cpp:134-177) with an in-framework coder whose encode AND decode are
data-parallel: the payload is split into L interleaved lanes, each lane is
an independent 32-bit rANS stream, and all lanes advance in lockstep —
one vectorized step per symbol position. That lockstep shape is exactly
what a TPU wants (the reference's xz is inherently sequential).

Coder family: range-ANS, 32-bit state, 16-bit renormalization, 12-bit
quantized frequencies (SCALE = 4096).

- order-0: one 256-symbol model for the whole section
- order-1: 256 models keyed on the previous byte (the previous byte of the
  SAME lane's slice, so decode stays parallel)

Freq tables are built per section from the actual data (two-pass, exact),
quantized so every present symbol keeps freq >= 1, and serialized sparsely.

Wire layout per section (all little-endian):
  u8   order (0 or 1)
  u32  n_bytes (raw length)
  u16  n_lanes
  [tables]   order-0: table; order-1: 256 tables, each preceded by u8
             n_present (0 => context unused, no table bytes)
  u32  payload_len, then per-lane u32 byte counts, then lane payloads
       back-to-back (each lane's bytes in DECODE order)

Table serialization: u8 n_present-1, then n_present * (u8 sym, u16 freq).
"""

from __future__ import annotations

import numpy as np

SCALE_BITS = 12
SCALE = 1 << SCALE_BITS
RANS_L = 1 << 16  # lower bound of the normalized interval
DEFAULT_LANES = 4096


class RansTruncated(ValueError):
    """The buffered bytes end mid-section: callers that stream compressed
    data (format/rfqz.py RfqzReader) should fetch more and retry. Distinct
    from plain ValueError, which means the section is genuinely corrupt."""


# ---------------------------------------------------------------------------
# frequency tables
# ---------------------------------------------------------------------------


def quantize_freqs(counts: np.ndarray) -> np.ndarray:
    """Exact-sum quantization of symbol counts to SCALE with every present
    symbol >= 1 (largest-remainder style, deterministic)."""
    counts = counts.astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(256, dtype=np.int64)
    present = counts > 0
    npresent = int(present.sum())
    if npresent == 1:
        f = np.zeros(256, dtype=np.int64)
        f[np.argmax(counts)] = SCALE
        return f
    scaled = counts * (SCALE - npresent) // total + np.where(present, 1, 0)
    # distribute the remainder to the largest counts (stable by symbol)
    diff = SCALE - int(scaled.sum())
    if diff != 0:
        order = np.lexsort((np.arange(256), -counts))
        i = 0
        step = 1 if diff > 0 else -1
        while diff != 0:
            s = order[i % npresent]
            if step < 0 and scaled[s] <= 1:
                i += 1
                continue
            scaled[s] += step
            diff -= step
            i += 1
    return scaled


def serialize_table(freqs: np.ndarray) -> bytes:
    """Compact frequency table (rfqz v3): symbol presence as an explicit
    ascending list (npresent <= 32), a 32-byte bitmap (33..255), or
    nothing (all 256 present); then varint(freq-1) per present symbol in
    ascending order with the LAST frequency implied by sum == SCALE.
    Cuts the dominant .rfqz overhead — order-1 sections carry up to 256
    of these — from 3 B/entry to ~1.1 B/entry."""
    syms = np.flatnonzero(freqs)
    npresent = len(syms)
    out = bytearray([npresent - 1])
    if npresent <= 32:
        out += bytes(int(s) for s in syms)
    elif npresent < 256:
        bitmap = np.zeros(32, dtype=np.uint8)
        np.bitwise_or.at(bitmap, syms >> 3, (1 << (syms & 7)).astype(np.uint8))
        out += bitmap.tobytes()
    for s in syms[:-1]:
        v = int(freqs[s]) - 1
        if v < 128:
            out.append(v)
        else:
            out.append(0x80 | (v & 0x7F))
            out.append(v >> 7)
    return bytes(out)


def parse_table(buf: memoryview, off: int) -> tuple[np.ndarray, int]:
    from . import _native

    if _native.available():
        arr = np.frombuffer(buf, dtype=np.uint8)
        freqs, new_off = _native.rans_parse_table(arr, off, SCALE)
        if new_off >= 0:
            return freqs, new_off
        if new_off == -1:
            raise RansTruncated("rANS section truncated (table)")
        if new_off == -2:
            raise ValueError("rANS table symbol list not ascending")
        if new_off == -3:
            raise ValueError("rANS table symbol bitmap count mismatch")
        raise ValueError("rANS frequency table corrupt (sum > %d)" % SCALE)
    if len(buf) - off < 1:
        raise RansTruncated("rANS section truncated (table header)")
    npresent = buf[off] + 1
    off += 1
    if npresent == 256:
        syms = range(256)
    elif npresent <= 32:
        if len(buf) - off < npresent:
            raise RansTruncated("rANS section truncated (symbol list)")
        syms = list(buf[off : off + npresent])
        off += npresent
        if any(b <= a for a, b in zip(syms, syms[1:])):
            raise ValueError("rANS table symbol list not ascending")
    else:
        if len(buf) - off < 32:
            raise RansTruncated("rANS section truncated (symbol bitmap)")
        bitmap = np.frombuffer(buf, dtype=np.uint8, count=32, offset=off)
        off += 32
        syms = np.flatnonzero(
            np.unpackbits(bitmap, bitorder="little")
        )
        if len(syms) != npresent:
            raise ValueError("rANS table symbol bitmap count mismatch")
    freqs = np.zeros(256, dtype=np.int64)
    total = 0
    syms = list(syms)
    for s in syms[:-1]:
        if len(buf) - off < 1:
            raise RansTruncated("rANS section truncated (table freqs)")
        v = buf[off]
        off += 1
        if v & 0x80:
            if len(buf) - off < 1:
                raise RansTruncated("rANS section truncated (table freqs)")
            v = (v & 0x7F) | (buf[off] << 7)
            off += 1
        freqs[s] = v + 1
        total += v + 1
    if not syms or total >= SCALE:
        # decoders build a SCALE-sized symbol LUT from this table; a
        # non-positive implied frequency would corrupt the LUT layout
        raise ValueError("rANS frequency table corrupt (sum > %d)" % SCALE)
    freqs[syms[-1]] = SCALE - total
    return freqs, off


_CTX_BITMAP_LEN = 32


def serialize_ctx_tables(freqs_all: np.ndarray) -> bytes:
    """Order-1 table block (rfqz v3): 32-byte context-presence bitmap,
    then one compact table per present context in ascending order
    (replaces the v2 per-context flag byte: 256 B -> 32 B)."""
    present = np.flatnonzero(freqs_all.any(axis=1))
    bitmap = np.zeros(_CTX_BITMAP_LEN, dtype=np.uint8)
    np.bitwise_or.at(bitmap, present >> 3, (1 << (present & 7)).astype(np.uint8))
    out = bytearray(bitmap.tobytes())
    for c in present:
        out += serialize_table(freqs_all[c])
    return bytes(out)


def parse_ctx_tables(buf: memoryview, off: int) -> tuple[np.ndarray, int]:
    if len(buf) - off < _CTX_BITMAP_LEN:
        raise RansTruncated("rANS section truncated (context bitmap)")
    bitmap = np.frombuffer(
        buf, dtype=np.uint8, count=_CTX_BITMAP_LEN, offset=off
    )
    off += _CTX_BITMAP_LEN
    freqs_all = np.zeros((256, 256), dtype=np.int64)
    for c in np.flatnonzero(np.unpackbits(bitmap, bitorder="little")):
        freqs_all[c], off = parse_table(buf, off)
    return freqs_all, off


def pack_ctx_tables(freqs_all: np.ndarray) -> bytes:
    """Order-1 table block with its own entropy stage: a flag byte, then
    either the raw serialize_ctx_tables blob (0) or that blob wrapped in
    a nested order-0 rANS section (1), whichever is smaller. A dense
    order-1 section carries up to 256 compact tables (~30-40 KB on a
    256-alphabet stream) whose varint bytes are highly skewed — order-0
    coding them recovers another ~25-30% of the table cost."""
    blob = serialize_ctx_tables(freqs_all)
    if len(blob) >= 1024:
        nested = encode_section(
            np.frombuffer(blob, dtype=np.uint8), order=0, lanes=16
        )
        if len(nested) < len(blob):
            return b"\x01" + nested
    return b"\x00" + blob


def unpack_ctx_tables(buf: memoryview, off: int) -> tuple[np.ndarray, int]:
    if len(buf) - off < 1:
        raise RansTruncated("rANS section truncated (table block flag)")
    flag = buf[off]
    off += 1
    if flag == 0:
        return parse_ctx_tables(buf, off)
    if flag != 1:
        raise ValueError("rANS order-1 table block flag corrupt")
    blob, off = decode_section(buf, off)
    freqs_all, used = parse_ctx_tables(memoryview(blob), 0)
    if used != len(blob):
        raise ValueError("rANS order-1 table block length mismatch")
    return freqs_all, off


def _cum_from_freqs(freqs: np.ndarray) -> np.ndarray:
    cum = np.zeros(257, dtype=np.int64)
    np.cumsum(freqs, out=cum[1:])
    return cum


# ---------------------------------------------------------------------------
# lane split
# ---------------------------------------------------------------------------


def lane_slices(n: int, lanes: int) -> np.ndarray:
    """Start offsets (lanes+1,) of contiguous per-lane slices; lane i gets
    ceil/floor split with remainders on the first lanes."""
    base = n // lanes
    rem = n % lanes
    sizes = np.full(lanes, base, dtype=np.int64)
    sizes[:rem] += 1
    out = np.zeros(lanes + 1, dtype=np.int64)
    np.cumsum(sizes, out=out[1:])
    return out


def _to_padded(data: np.ndarray, lanes: int) -> tuple[np.ndarray, np.ndarray, int]:
    """(steps, lanes) column of each lane's slice, padded at the tail with
    sym 0 (masked by per-lane lengths); plus per-lane lengths and steps."""
    n = data.shape[0]
    off = lane_slices(n, lanes)
    lens = np.diff(off)
    steps = int(lens.max()) if n else 0
    grid = np.zeros((steps, lanes), dtype=np.uint8)
    for i in range(lanes):
        grid[: lens[i], i] = data[off[i] : off[i + 1]]
    return grid, lens, steps


def _prev_grid(grid: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Order-1 context: previous byte within the lane slice (0 for the
    first element of each lane)."""
    prev = np.zeros_like(grid)
    prev[1:] = grid[:-1]
    return prev


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------


def encode_section(data: bytes | np.ndarray, order: int = 0,
                   lanes: int = DEFAULT_LANES,
                   counts0: np.ndarray | None = None,
                   pair_counts: np.ndarray | None = None) -> bytes:
    """Entropy-code one byte section. Returns the self-contained section
    record (header + tables + interleaved payload).

    counts0 / pair_counts: optional precomputed byte histogram and RAW
    consecutive-pair histogram (65536,) over data — the mode chooser
    already computed them; lane-boundary corrections are applied here."""
    data = np.frombuffer(data, dtype=np.uint8) if isinstance(
        data, (bytes, bytearray, memoryview)
    ) else np.asarray(data, dtype=np.uint8)
    n = data.shape[0]
    lanes = max(1, min(lanes, max(1, n)))
    head = bytearray()
    head.append(order)
    head += int(n).to_bytes(4, "little")
    head += int(lanes).to_bytes(2, "little")
    if n == 0:
        head += (0).to_bytes(4, "little")
        return bytes(head)

    if order == 0:
        counts = (
            np.bincount(data, minlength=256)
            if counts0 is None else counts0.astype(np.int64)
        )
        freqs = quantize_freqs(counts)
        head += serialize_table(freqs)
        cum = _cum_from_freqs(freqs)
        freq_flat, cum_flat = freqs, cum[:256]
    else:
        # contexts from overlapping byte pairs, then exact corrections at
        # lane boundaries (each lane's first byte has context 0, and the
        # pair that straddles a boundary doesn't exist)
        off = lane_slices(n, lanes)
        if pair_counts is None:
            key = ((data[:-1].astype(np.uint16) << 8) | data[1:]).astype(
                np.int64
            )
            ctx_counts = np.bincount(key, minlength=65536)
        else:
            ctx_counts = pair_counts.astype(np.int64).copy()
        for i in range(lanes):
            s = int(off[i])
            if s >= n:
                break
            if i > 0:
                ctx_counts[(int(data[s - 1]) << 8) | int(data[s])] -= 1
            ctx_counts[int(data[s])] += 1
        ctx_counts = ctx_counts.reshape(256, 256)
        freqs_all = np.zeros((256, 256), dtype=np.int64)
        for c in range(256):
            if ctx_counts[c].any():
                freqs_all[c] = quantize_freqs(ctx_counts[c])
        head += pack_ctx_tables(freqs_all)
        cum_all = np.zeros((256, 257), dtype=np.int64)
        np.cumsum(freqs_all, axis=1, out=cum_all[:, 1:])
        freq_flat, cum_flat = freqs_all, cum_all[:, :256]

    # native fast path: per-lane scalar loops at memory speed (exact same
    # bytes; cross-checked in tests/test_rans.py)
    from . import _native

    if _native.available():
        off = lane_slices(n, lanes)
        payload_n, counts_n = _native.rans_encode(
            data,
            off,
            np.ascontiguousarray(freq_flat.reshape(-1), dtype=np.int32),
            np.ascontiguousarray(cum_flat.reshape(-1), dtype=np.int32),
            order,
        )
        body = bytearray()
        body += int(payload_n.shape[0]).to_bytes(4, "little")
        body += counts_n.astype("<u4").tobytes()
        body += payload_n.tobytes()
        return bytes(head) + bytes(body)

    grid, lens, steps = _to_padded(data, lanes)
    if order == 0:
        f_of = freqs[grid]  # (steps, lanes)
        c_of = cum[grid]
    else:
        prev = _prev_grid(grid, lens)
        f_of = freqs_all[prev, grid]
        c_of = cum_all[prev, grid]

    # rANS encode: process symbols in REVERSE so decode runs forward.
    # Each lane's output bytes are collected encoder-order then reversed,
    # giving decode-order payloads.
    state = np.full(lanes, RANS_L, dtype=np.uint64)
    active_template = np.arange(lanes)
    out_bytes: list[np.ndarray] = []
    out_lane: list[np.ndarray] = []
    x_max_mul = (RANS_L >> SCALE_BITS) << 16
    for t in range(steps - 1, -1, -1):
        act = active_template[lens > t]
        f = f_of[t, act].astype(np.uint64)
        c = c_of[t, act].astype(np.uint64)
        s = state[act]
        # renormalize: while state >= f * x_max_mul -> emit 2 bytes
        x_max = f * x_max_mul
        over = s >= x_max
        while over.any():
            idx = act[over]
            out_bytes.append((state[idx] & 0xFFFF).astype(np.uint16))
            out_lane.append(idx)
            state[idx] >>= np.uint64(16)
            s = state[act]
            over = s >= x_max
        state[act] = (s // f << np.uint64(SCALE_BITS)) + (s % f) + c

    # flush 4 bytes of final state per lane (encoder-order: low to high)
    lane_chunks: list[list[np.ndarray]] = [[] for _ in range(lanes)]
    if out_bytes:
        all_b = np.concatenate([b.astype(np.uint16) for b in out_bytes])
        all_l = np.concatenate(out_lane)
        ordr = np.argsort(all_l, kind="stable")
        sb = all_b[ordr]
        sl = all_l[ordr]
        bounds = np.searchsorted(sl, np.arange(lanes + 1))
        for i in range(lanes):
            lane_chunks[i].append(sb[bounds[i] : bounds[i + 1]])

    payloads = []
    counts_out = np.zeros(lanes, dtype=np.int64)
    for i in range(lanes):
        parts = lane_chunks[i][0] if lane_chunks[i] else np.empty(0, np.uint16)
        # encoder emitted u16 words; decode order = reverse
        words = parts[::-1]
        by = np.empty(words.shape[0] * 2, dtype=np.uint8)
        by[0::2] = (words >> 8) & 0xFF  # decode reads high byte first
        by[1::2] = words & 0xFF
        final = int(state[i])
        head4 = np.frombuffer(final.to_bytes(4, "little"), dtype=np.uint8)
        lane_payload = np.concatenate([head4, by])
        payloads.append(lane_payload)
        counts_out[i] = lane_payload.shape[0]

    payload = np.concatenate(payloads) if payloads else np.empty(0, np.uint8)
    body = bytearray()
    body += int(payload.shape[0]).to_bytes(4, "little")
    body += counts_out.astype("<u4").tobytes()
    body += payload.tobytes()
    return bytes(head) + bytes(body)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def decode_section(buf: bytes | memoryview, off: int = 0) -> tuple[bytes, int]:
    """Decode one section record starting at off; returns (raw, new_off)."""
    buf = memoryview(buf)
    if len(buf) - off < 7:
        # with < 7 bytes buffered, n would parse from a short slice as a
        # small/zero value and silently desync the stream
        raise RansTruncated("rANS section truncated (header)")
    order = buf[off]
    n = int.from_bytes(buf[off + 1 : off + 5], "little")
    lanes = int.from_bytes(buf[off + 5 : off + 7], "little")
    off += 7
    if n == 0:
        if len(buf) - off < 4:
            raise RansTruncated("rANS section truncated (empty payload len)")
        return b"", off + 4
    if lanes < 1:
        # an empty lane table would pass the sum/parity checks below and
        # then divide by zero in lane_slices
        raise ValueError("rANS section lane count corrupt (0 with n > 0)")

    if order == 0:
        freqs, off = parse_table(buf, off)
        cum = _cum_from_freqs(freqs)
        sym_of = np.repeat(np.arange(256, dtype=np.uint8), freqs)  # (SCALE,)
        freq_lut = freqs[sym_of]
        cum_lut = cum[sym_of]
    else:
        freqs_all, off = unpack_ctx_tables(buf, off)
        cum_all = np.zeros((256, 257), dtype=np.int64)
        np.cumsum(freqs_all, axis=1, out=cum_all[:, 1:])
        sym_of = np.zeros((256, SCALE), dtype=np.uint8)
        for c in range(256):
            if freqs_all[c].any():
                sym_of[c] = np.repeat(
                    np.arange(256, dtype=np.uint8), freqs_all[c]
                )

    if len(buf) - off < 4:
        raise RansTruncated("rANS section truncated (payload len)")
    payload_len = int.from_bytes(buf[off : off + 4], "little")
    off += 4
    if off + 4 * lanes + payload_len > len(buf):
        raise RansTruncated("rANS section truncated (payload)")
    lane_counts = np.frombuffer(buf, dtype="<u4", count=lanes, offset=off).astype(
        np.int64
    )
    off += 4 * lanes
    payload = np.frombuffer(buf, dtype=np.uint8, count=payload_len, offset=off)
    off += payload_len
    # the native decoder trusts these; validate before it touches memory
    if int(lane_counts.sum()) != payload_len or (lane_counts < 4).any() or (
        ((lane_counts - 4) % 2) != 0
    ).any():
        raise ValueError("rANS section lane table corrupt")

    from . import _native

    if _native.available():
        offs = lane_slices(n, lanes)
        if order == 0:
            freq_flat = freqs.astype(np.int32)
            cum_flat = _cum_from_freqs(freqs)[:256].astype(np.int32)
            sym_flat = np.repeat(np.arange(256, dtype=np.uint8), freqs)
        else:
            freq_flat = freqs_all.reshape(-1).astype(np.int32)
            cum_flat = cum_all[:, :256].reshape(-1).astype(np.int32)
            sym_flat = sym_of.reshape(-1)
        out = _native.rans_decode(
            np.ascontiguousarray(payload), lane_counts, offs,
            np.ascontiguousarray(freq_flat), np.ascontiguousarray(cum_flat),
            np.ascontiguousarray(sym_flat), order,
        )
        return out.tobytes(), off

    lane_starts = np.zeros(lanes + 1, dtype=np.int64)
    np.cumsum(lane_counts, out=lane_starts[1:])

    # initial states: first 4 bytes of each lane payload (LE)
    s0 = lane_starts[:-1]
    state = (
        payload[s0].astype(np.uint64)
        | (payload[s0 + 1].astype(np.uint64) << np.uint64(8))
        | (payload[s0 + 2].astype(np.uint64) << np.uint64(16))
        | (payload[s0 + 3].astype(np.uint64) << np.uint64(24))
    )
    ptr = s0 + 4

    offs = lane_slices(n, lanes)
    lens = np.diff(offs)
    steps = int(lens.max())
    out = np.zeros((steps, lanes), dtype=np.uint8)
    prev = np.zeros(lanes, dtype=np.uint8)
    mask = np.uint64(SCALE - 1)
    lane_end = lane_starts[1:]
    for t in range(steps):
        act = lens > t
        slot = (state & mask).astype(np.int64)
        if order == 0:
            sym = sym_of[slot]
            f = freq_lut[slot].astype(np.uint64)
            c = cum_lut[slot].astype(np.uint64)
        else:
            sym = sym_of[prev, slot]
            f = freqs_all[prev, sym].astype(np.uint64)
            c = cum_all[prev, sym].astype(np.uint64)
        new_state = f * (state >> np.uint64(SCALE_BITS)) + (state & mask) - c
        state = np.where(act, new_state, state)
        out[t] = np.where(act, sym, 0)
        prev = np.where(act, sym, prev)
        # renormalize: consume one u16 word while state < RANS_L
        need = act & (state < RANS_L) & (ptr < lane_end)
        while need.any():
            p = np.where(need, ptr, 0)
            hi = payload[p].astype(np.uint64)
            lo = payload[np.minimum(p + 1, payload_len - 1)].astype(np.uint64)
            word = (hi << np.uint64(8)) | lo
            state = np.where(need, (state << np.uint64(16)) | word, state)
            ptr = np.where(need, ptr + 2, ptr)
            need = act & (state < RANS_L) & (ptr < lane_end)
    # reassemble lanes
    raw = np.zeros(n, dtype=np.uint8)
    for i in range(lanes):
        raw[offs[i] : offs[i + 1]] = out[: lens[i], i]
    return raw.tobytes(), off
