"""The `.rfqz` second entropy stage on the card: interleaved rANS, the port
of repaq_tpu/ops/rans_device.py, byte-exact with the host oracle
repaq_tpu/codec/rans_np.py.

A section's bytes are cut into L contiguous lane slices
(``rans_np.lane_slices``: the first ``n % L`` lanes take one byte more),
and each lane is an independent 32-bit rANS stream (16-bit
renormalisation, 12-bit scale; order-1 contexts are the previous byte of
the same lane). The JAX module codes only sections with ``n % L == 0`` and
sends the rest to the host oracle; the writer rarely makes such sections,
so here every lane has its own length and every section takes the kernels.

Three CUDA kernels (``csrc/rans.cu``) replace the JAX module's two
``lax.scan`` loops and its payload sort:

- ``rans_encode``: one thread per lane walks its slice backwards and
  writes, per step, the word and whether it was emitted, in JAX's
  (steps, lanes) layout, and the lane's final state; its bytes are staged
  in shared memory a window ahead, and ``rcp_table`` takes the division
  off its state step;
- ``rans_layout``: writes each lane's final state and emitted words in
  decode order to the lane's start in the payload (every destination once,
  no sort), one block a tile of steps x lanes staged in shared memory (the
  built shape is ``layout_tile()``), each lane's base from the counts the
  tiles above it publish, a warp writing a lane's words as one run;
- ``rans_decode``: one thread per lane runs the decoder forward over its
  payload bytes into its slice of the output, its bytes staged in shared
  memory a window ahead, its output staged and copied out in runs, and
  the section's tables packed per context by ``decode_table`` (the live
  rows in shared memory when at most ``decode_shared_rows()`` contexts
  are live: the "shared" route; else all rows read from global memory:
  "global").

The wrappers follow ops/kernels.py: a CPU tensor runs the plain torch
version (same signature, the lanes in lockstep, one step of int64
elementwise ops per symbol, uint32 values masked), a CUDA tensor launches
the kernel or raises, and every launch counts in ``kernels.launches``.

The section drivers ``encode_section_device`` and ``decode_section_device``
are drop-ins for ``rans_np.encode_section`` and ``rans_np.decode_section``
(same bytes, same return values) with an explicit ``device``. The header
and the frequency tables are built and parsed on the host with rans_np's
own functions.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codec import rans_np

from . import _build
from .kernels import _aligned, _check_u8, _launch, _on_cuda, _stream

SCALE_BITS = rans_np.SCALE_BITS
SCALE = rans_np.SCALE
RANS_L = rans_np.RANS_L
_U32 = 0xFFFFFFFF


def _as_u8(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(data, dtype=np.uint8)
    return np.asarray(data, dtype=np.uint8)


def _to(a: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on `device` (copied first when numpy holds
    it read-only, as for arrays over bytes)."""
    return torch.from_numpy(a if a.flags.writeable else a.copy()).to(device)


# ---------------------------------------------------------------------------
# host side: header and tables
# ---------------------------------------------------------------------------


def section_prologue(arr: np.ndarray, order: int, lanes: int):
    """Header and tables of a section of n = len(arr) >= 1 bytes in
    1 <= lanes <= n lanes, as rans_np.encode_section builds them
    (rans_np.py:298-343), the order-1 lane-boundary corrections included.
    Returns (head bytes, freqs, cum): (256,) int64 tables for order-0,
    (256, 256) for order-1 (row = context); cum is exclusive."""
    n = arr.shape[0]
    head = bytearray([order])
    head += n.to_bytes(4, "little")
    head += lanes.to_bytes(2, "little")
    if order == 0:
        freqs = rans_np.quantize_freqs(np.bincount(arr, minlength=256))
        head += rans_np.serialize_table(freqs)
    else:
        ctx = np.bincount((arr[:-1].astype(np.int64) << 8) | arr[1:],
                          minlength=65536)
        starts = rans_np.lane_slices(n, lanes)[:-1]
        # each lane's first byte has context 0, and the pair that
        # straddles a lane start is not coded
        inner = starts[1:]
        np.subtract.at(ctx, (arr[inner - 1].astype(np.int64) << 8)
                       | arr[inner], 1)
        np.add.at(ctx, arr[starts].astype(np.int64), 1)
        ctx = ctx.reshape(256, 256)
        freqs = np.zeros((256, 256), dtype=np.int64)
        for c in np.flatnonzero(ctx.any(axis=1)):
            freqs[c] = rans_np.quantize_freqs(ctx[c])
        head += rans_np.pack_ctx_tables(freqs)
    return bytes(head), freqs, np.cumsum(freqs, axis=-1) - freqs


def _parse_tables(buf: memoryview, off: int, order: int):
    """(freqs, cum, sym_lut, new off) of a section's table block: sym_lut
    is (SCALE,) u8 for order-0 and (256, SCALE) for order-1."""
    sym_of = np.arange(256, dtype=np.uint8)
    if order == 0:
        freqs, off = rans_np.parse_table(buf, off)
        sym = np.repeat(sym_of, freqs)
    else:
        freqs, off = rans_np.unpack_ctx_tables(buf, off)
        sym = np.zeros((256, SCALE), dtype=np.uint8)
        for c in np.flatnonzero(freqs.any(axis=1)):
            sym[c] = np.repeat(sym_of, freqs[c])
    return freqs, np.cumsum(freqs, axis=-1) - freqs, sym, off


# ---------------------------------------------------------------------------
# kernel wrappers and their plain versions
# ---------------------------------------------------------------------------


def _lane_offsets(n: int, lanes: int, offsets) -> tuple[np.ndarray, int]:
    """Host lane offsets (lanes+1,) int64 (rans_np.lane_slices unless
    given) and the longest lane's length."""
    if lanes < 1:
        raise ValueError("need at least one lane, got %d" % lanes)
    if offsets is None:
        off = rans_np.lane_slices(n, lanes)
    else:
        off = np.asarray(offsets, dtype=np.int64)
        if (off.shape != (lanes + 1,) or off[0] != 0 or off[-1] != n
                or (np.diff(off) < 0).any()):
            raise ValueError("offsets must be (lanes+1,) ascending from 0 "
                             "to n=%d" % n)
    return off, int(np.diff(off).max())


def _check_tables(freq_lut, cum_lut, order: int, sym_lut=None) -> None:
    shape = (256,) if order == 0 else (256, 256)
    if tuple(freq_lut.shape) != shape or tuple(cum_lut.shape) != shape:
        raise ValueError("order-%d tables must be %s, got %s and %s"
                         % (order, shape, tuple(freq_lut.shape),
                            tuple(cum_lut.shape)))
    if (sym_lut is not None
            and sym_lut.numel() != SCALE * (1 if order == 0 else 256)):
        raise ValueError("sym_lut must hold %d entries per context" % SCALE)


def _fc_table(freq_lut: torch.Tensor, cum_lut: torch.Tensor, order: int):
    """freq | cum << 16 in one int32 per entry (freq <= SCALE, cum <
    SCALE): (256,) for order-0, (65536,) for order-1 (context-major)."""
    _check_tables(freq_lut, cum_lut, order)
    return (freq_lut.to(torch.int32)
            | (cum_lut.to(torch.int32) << 16)).reshape(-1).contiguous()


def rcp_table() -> np.ndarray:
    """The reciprocals that take the division off ``rans_encode``'s state
    chain: (SCALE + 1, 2) uint32, row f (1 <= f <= SCALE) holds (m, l) with
    l = ceil(log2 f) and m = floor(2^32 (2^l - f) / f) + 1 (Granlund and
    Montgomery's multiplier less its 2^32 bit), so that for every x < 2^32
    x // f = (x + umulhi(x, m)) >> l, the sum taken in 33 bits. Row 0 is
    unused. The kernel's state stays below f << 20, where the sum fits in
    32 bits (tests/test_torch_rans.py proves both)."""
    f = np.arange(SCALE + 1, dtype=np.int64)
    f[0] = 1
    l = np.array([int(v - 1).bit_length() for v in f], dtype=np.int64)
    m = (((1 << 32) * ((1 << l) - f)) // f + 1)
    table = np.stack([m, l], axis=1).astype(np.uint32)
    table[0] = 0
    return table


_rcp_tables: dict = {}


def _rcp_on(device: torch.device) -> torch.Tensor:
    """rcp_table() on `device`, built once per process and device."""
    t = _rcp_tables.get(device)
    if t is None:
        t = _rcp_tables[device] = torch.from_numpy(rcp_table()).to(device)
    return t


def _check_order(order: int) -> None:
    if order not in (0, 1):
        raise ValueError("order must be 0 or 1, got %r" % (order,))


def rans_encode_plain(data: torch.Tensor, freq_lut: torch.Tensor,
                      cum_lut: torch.Tensor, lanes: int, order: int):
    """Plain torch version of ``rans_encode_device``."""
    _check_order(order)
    off_np, steps = _lane_offsets(data.shape[0], lanes, None)
    fc = _fc_table(freq_lut, cum_lut, order).long()
    dev = data.device
    off = torch.from_numpy(off_np).to(dev)
    begin, end = off[:-1], off[1:]
    lens = end - begin
    d = data.long()
    x = torch.full((lanes,), RANS_L, dtype=torch.int64, device=dev)
    words = torch.zeros((steps, lanes), dtype=torch.int32, device=dev)
    emits = torch.zeros((steps, lanes), dtype=torch.bool, device=dev)
    for k in range(steps):
        act = lens > k
        p = (end - 1 - k).clamp(min=0)
        s = d[p]
        if order == 0:
            e = fc[s]
        else:
            prev = torch.where(p > begin, d[(p - 1).clamp(min=0)], 0)
            e = fc[(prev << 8) | s]
        f = torch.where(act, e & 0xFFFF, 1)
        emit = act & ((x >> 20) >= f)
        words[k] = torch.where(act, x & 0xFFFF, 0).to(torch.int32)
        emits[k] = emit
        x = torch.where(emit, x >> 16, x)
        x = torch.where(act, (((x // f) << SCALE_BITS) + x % f + (e >> 16))
                        & _U32, x)
    return words.to(torch.uint16), emits, x


def rans_encode_device(data: torch.Tensor, freq_lut: torch.Tensor,
                       cum_lut: torch.Tensor, lanes: int, order: int):
    """Encode (n,) u8 data in `lanes` lanes with per-symbol tables: the
    signature and result of repaq_tpu.ops.rans_device.rans_encode_device
    (:110), which takes only n % lanes == 0, for any n.

    freq_lut/cum_lut: (256,) ints for order-0, (256, 256) for order-1 (row
    = the previous byte's context), on data's device. Lane i codes
    data[off[i]:off[i+1]] with off = rans_np.lane_slices(n, lanes): JAX's
    grid on the equal split, the host coder's lanes on a ragged one (the
    first n % lanes lanes one byte longer). Returns (words
    (steps, lanes) uint16 in encoder order, emits (steps, lanes) bool,
    final (lanes,) int64 states in [2^16, 2^32)): row k of lane i codes the
    lane's k-th byte from its end, steps is the longest lane, and rows past
    a shorter lane's end are 0 and not emitted. The kernel is
    ``rans_encode``."""
    _check_u8("data", data)
    _check_order(order)
    steps = _lane_offsets(data.shape[0], lanes, None)[1]
    fc = _fc_table(freq_lut, cum_lut, order)
    if not _on_cuda(data, fc):
        return rans_encode_plain(data, freq_lut, cum_lut, lanes, order)
    lib = _build.library()
    dev = data.device
    data = data.contiguous()
    words = torch.empty((steps, lanes), dtype=torch.uint16, device=dev)
    emits = torch.empty((steps, lanes), dtype=torch.bool, device=dev)
    final = torch.empty(lanes, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        # the kernel splits the lanes as rans_np.lane_slices does
        _launch("rans_encode", lib.repaq_rans_encode, data.data_ptr(),
                data.shape[0], lanes, fc.data_ptr(),
                _rcp_on(dev).data_ptr(), order, steps, words.data_ptr(),
                emits.data_ptr(), final.data_ptr(), _stream(dev))
    return words, emits, final


def encode_window() -> int:
    """Steps of a lane that the built ``rans_encode`` stages at once in
    shared memory (card-side tests place lane lengths by it)."""
    return int(_build.library().repaq_rans_encode_window())


def layout_tile() -> tuple[int, int]:
    """(steps, lanes) of the built ``rans_layout``'s tile: one block lays
    out that many steps of that many lanes (card-side tests place their
    edge cases by it)."""
    lib = _build.library()
    return (int(lib.repaq_rans_layout_tile_steps()),
            int(lib.repaq_rans_layout_tile_lanes()))


def rans_layout_plain(words: torch.Tensor, emits: torch.Tensor,
                      final: torch.Tensor, start: torch.Tensor,
                      out_cap: int) -> torch.Tensor:
    """Plain torch version of ``rans_layout``."""
    dev = words.device
    # the word emitted at step k comes after every word emitted later in
    # the scan: its place in decode order is the count of those
    rank = emits.flip(0).long().cumsum(0).flip(0) - 1
    at = (start[None, :] + 4 + 2 * rank)[emits]
    w = words.long()[emits]
    b = torch.arange(4, device=dev)
    pos = torch.cat([(start[:, None] + b).reshape(-1), at, at + 1])
    val = torch.cat([((final[:, None] >> (8 * b)) & 0xFF).reshape(-1),
                     w >> 8, w & 0xFF])
    keep = pos < out_cap
    payload = torch.zeros(out_cap, dtype=torch.uint8, device=dev)
    payload[pos[keep]] = val[keep].to(torch.uint8)
    return payload


def rans_layout(words: torch.Tensor, emits: torch.Tensor,
                final: torch.Tensor, start: torch.Tensor,
                out_cap: int) -> torch.Tensor:
    """The payload image (out_cap,) u8 of ``rans_encode_device``'s result:
    from start[i], lane i's final state (4 bytes LE), then its emitted
    words in decode order (the scan's last emitted word first), high byte
    first. Bytes at or past out_cap are dropped; the rest is zero. The
    kernel is ``rans_layout``."""
    if (words.dim() != 2 or emits.shape != words.shape
            or final.shape != (words.shape[1],) or start.shape != final.shape
            or words.dtype != torch.uint16 or emits.dtype != torch.bool):
        raise ValueError("need words (steps, lanes) uint16, emits of their "
                         "shape bool, final and start (lanes,)")
    if not _on_cuda(words, emits, final, start):
        return rans_layout_plain(words, emits, final, start, out_cap)
    lib = _build.library()
    dev = words.device
    steps, lanes = words.shape
    words, emits = words.contiguous(), emits.contiguous()
    final = final.to(torch.int64).contiguous()
    start = start.to(torch.int64).contiguous()
    # one fill zeroes the payload and, 16-byte aligned past it, the kernel's
    # status words (a count per tile and lane) and its ticket counter
    head = -(-out_cap // 16) * 16
    buf = torch.zeros(head + 4 * lib.repaq_rans_layout_status_words(
        lanes, steps), dtype=torch.uint8, device=dev)
    payload = buf[:out_cap]
    with torch.cuda.device(dev):
        _launch("rans_layout", lib.repaq_rans_layout, words.data_ptr(),
                emits.data_ptr(), final.data_ptr(), start.data_ptr(), lanes,
                steps, payload.data_ptr(), out_cap, buf[head:].data_ptr(),
                _stream(dev))
    return payload


def rans_encode_payload_device(data: torch.Tensor, freq_lut: torch.Tensor,
                               cum_lut: torch.Tensor, lanes: int, order: int,
                               out_cap: int):
    """Encode to the container's payload image: the signature and result
    of repaq_tpu.ops.rans_device.rans_encode_payload_device (:158). Per
    lane [4 B final state LE][u16 words in decode order, high byte first],
    lanes back to back, any n (lanes as in ``rans_encode_device``).
    Returns (payload (out_cap,) u8 zero-padded, lane_bytes (lanes,) int64,
    total 0-d int64), all on data's device."""
    words, emits, final = rans_encode_device(data, freq_lut, cum_lut, lanes,
                                             order)
    lane_bytes = 4 + 2 * emits.sum(0)
    start = torch.cumsum(lane_bytes, 0) - lane_bytes
    payload = rans_layout(words, emits, final, start, out_cap)
    return payload, lane_bytes, lane_bytes.sum()


def _decode_offsets(payload, lane_counts, lanes, steps, offsets):
    """Host lane offsets (lanes+1,) int64 of a decode: the equal split of
    lanes * steps bytes, or the given `offsets`, which must be
    rans_np.lane_slices' split, the only one the section format has."""
    _check_u8("payload", payload)
    if tuple(lane_counts.shape) != (lanes,):
        raise ValueError("lane_counts must be (%d,), got %s"
                         % (lanes, tuple(lane_counts.shape)))
    if offsets is None:
        if lanes < 1:
            raise ValueError("need at least one lane, got %d" % lanes)
        return np.arange(lanes + 1, dtype=np.int64) * steps
    n = int(np.asarray(offsets)[-1])
    off = _lane_offsets(n, lanes, offsets)[0]
    if not np.array_equal(off, rans_np.lane_slices(n, lanes)):
        raise ValueError("offsets must be rans_np.lane_slices(%d, %d), the "
                         "section format's split" % (n, lanes))
    return off


def _decode_result(out: torch.Tensor, lanes: int, steps: int, offsets):
    return out.view(lanes, steps).T if offsets is None else out


_consts: dict = {}


def _const(name: str, device: torch.device) -> torch.Tensor:
    """Constants of the table packing on `device`, built once per process
    and device: "slot" (SCALE,) slot << 20 and "next" (256,) r << 12 - 1,
    int64."""
    t = _consts.get((name, device))
    if t is None:
        t = {"slot": torch.arange(SCALE) << 20,
             "next": (torch.arange(256) << 12) - 1}[name]
        t = _consts[(name, device)] = t.to(device)
    return t


def live_contexts(freqs: np.ndarray) -> int:
    """The live contexts of host tables (256,) or (256, 256): 1 for
    order-0, else the nonzero rows (at least 1)."""
    return 1 if freqs.ndim == 1 else max(1, int(freqs.any(axis=1).sum()))


def _live_of(freq_lut: torch.Tensor, order: int) -> int:
    """The live contexts of device tables, read on the host (one
    device-to-host copy on a card)."""
    return 1 if order == 0 else max(1, int(freq_lut.any(1).sum()))


def decode_table(sym_lut: torch.Tensor, freq_lut: torch.Tensor,
                 cum_lut: torch.Tensor, order: int, live: int | None):
    """The tables ``rans_decode`` reads, packed per context, built with
    torch on the tables' device. Returns (table (rows, SCALE) int32, syms
    (rows, SCALE) uint8 or None).

    Entry (r, slot) of a row, for the symbol s at that slot of the row's
    context in sym_lut, is (freq - 1) | next << 12 | (slot - cum) << 20 as
    a u32: freq and cum those of s in that context, next the row of s as a
    context (0 for order-0). The decoder's step is then x' = (freq - 1 +
    1) (x >> 12) + (slot - cum) and its next entry is in row next.

    With `live`, the live contexts (``_live_of``: the nonzero rows of
    freq_lut; 1 for order-0), the shared route's layout: the live rows
    only, ascending by context, a symbol that is no live context (on a
    valid section it only ends a lane) naming the last of them, so that
    every row a corrupt payload reaches lies in the table, and syms, each
    slot's symbol, the output byte. With None (order-1 only), the global
    route's: all 256 rows, row r being context r, so next is the symbol
    itself and the output byte, and syms is None."""
    _check_order(order)
    _check_tables(freq_lut, cum_lut, order, sym_lut)
    if order == 0 and live is None:
        raise ValueError("an order-0 table takes the shared route")
    dev = freq_lut.device
    ctx = 1 if order == 0 else 256
    sym = sym_lut.reshape(ctx, SCALE)
    # per (context, symbol): freq - 1 - cum << 20 + next << 12
    per_sym = torch.add(freq_lut.reshape(ctx, 256).long(),
                        cum_lut.reshape(ctx, 256), alpha=-(1 << 20))
    if order == 0:
        per_sym -= 1
    elif live is None:
        per_sym += _const("next", dev)
    else:
        # the live rows first, ascending; a symbol's next row is its place
        rows = torch.sort(freq_lut.any(1), descending=True,
                          stable=True).indices
        nxt = torch.empty_like(rows).scatter_(0, rows, _const("next", dev))
        per_sym += nxt.clamp_(max=((live - 1) << 12) - 1)
        per_sym, sym = per_sym[rows[:live]], sym[rows[:live]]
    table = (per_sym.gather(1, sym.long()) + _const("slot", dev)).to(
        torch.int32)
    return table, None if live is None else sym.to(torch.uint8)


def decode_window() -> int:
    """Steps of a lane that the built ``rans_decode`` decodes between two
    copy-outs of its staged bytes (card-side tests place lane lengths by
    it)."""
    return int(_build.library().repaq_rans_decode_window())


def decode_shared_rows() -> int:
    """Live contexts whose packed rows the built ``rans_decode`` holds in
    shared memory; more take the global route."""
    return int(_build.library().repaq_rans_decode_shared_rows())


# the routes ``rans_decode_device`` launched, and the last one's (order,
# live contexts, route)
decode_routes = {"shared": 0, "global": 0}
last_decode = None


def rans_decode_plain(payload: torch.Tensor, lane_counts: torch.Tensor,
                      sym_lut: torch.Tensor, freq_lut: torch.Tensor,
                      cum_lut: torch.Tensor, lanes: int, steps: int,
                      order: int, *, offsets=None) -> torch.Tensor:
    """Plain torch version of ``rans_decode_device``."""
    _check_order(order)
    off_np = _decode_offsets(payload, lane_counts, lanes, steps, offsets)
    fc = _fc_table(freq_lut, cum_lut, order).long()
    dev = payload.device
    lens = torch.from_numpy(np.diff(off_np)).to(dev)
    plen = payload.shape[0]
    # one zero byte past the end: every masked read lands there
    p = torch.cat([payload.long(), torch.zeros(1, dtype=torch.int64,
                                               device=dev)])
    ends = torch.cumsum(lane_counts.long(), 0)
    lane_end = ends.clamp(max=plen)

    def byte(pos, ok):
        return p[torch.where(ok, pos, plen)]

    ptr = ends - lane_counts.long()
    x = torch.zeros(lanes, dtype=torch.int64, device=dev)
    for b in range(4):
        x |= byte(ptr, ptr < lane_end) << (8 * b)
        ptr += 1
    sym = sym_lut.reshape(-1).long()
    prev = torch.zeros(lanes, dtype=torch.int64, device=dev)
    grid = torch.zeros((lanes, int(lens.max())), dtype=torch.uint8,
                       device=dev)
    for k in range(grid.shape[1]):
        act = lens > k
        slot = x & (SCALE - 1)
        if order == 0:
            s = sym[slot]
            e = fc[s]
        else:
            s = sym[(prev << SCALE_BITS) | slot]
            e = fc[(prev << 8) | s]
        xn = ((e & 0xFFFF) * (x >> SCALE_BITS) + slot - (e >> 16)) & _U32
        need = act & (xn < RANS_L) & (ptr + 1 < lane_end)
        word = (byte(ptr, need) << 8) | byte(ptr + 1, need)
        xn = torch.where(need, ((xn << 16) | word) & _U32, xn)
        ptr = torch.where(need, ptr + 2, ptr)
        x = torch.where(act, xn, x)
        prev = torch.where(act, s, prev)
        grid[:, k] = s.to(torch.uint8)
    keep = torch.arange(grid.shape[1], device=dev)[None, :] < lens[:, None]
    return _decode_result(grid[keep], lanes, steps, offsets)


def rans_decode_device(payload: torch.Tensor, lane_counts: torch.Tensor,
                       sym_lut: torch.Tensor, freq_lut: torch.Tensor,
                       cum_lut: torch.Tensor, lanes: int, steps: int,
                       order: int, *, offsets=None) -> torch.Tensor:
    """Decode a payload image: the signature of the general path of
    repaq_tpu.ops.rans_device.rans_decode_device (:250).

    payload: the lanes' bytes back to back (no padding needed; reads never
    pass a lane's end or the payload's); lane_counts (lanes,) bytes per
    lane; sym_lut (SCALE,) u8 for order-0, (256, SCALE) for order-1;
    freq_lut/cum_lut as for ``rans_encode_device``. Without `offsets`, the
    equal split of lanes * steps bytes, returned as JAX's (steps, lanes)
    grid; with host `offsets` (lanes+1,), which must be rans_np.lane_slices'
    split (ragged lanes), the flat (off[-1],) result (steps is then
    unused). The kernel is ``rans_decode``: the tables are packed on the
    card (``decode_table``) and the lane starts and the split computed in
    the kernel; the live contexts, counted on the card (one read), choose
    the route."""
    return _rans_decode(payload, lane_counts, sym_lut, freq_lut, cum_lut,
                        lanes, steps, order, offsets, None)


def _rans_decode(payload, lane_counts, sym_lut, freq_lut, cum_lut, lanes,
                 steps, order, offsets, live):
    """``rans_decode_device`` with `live`, the order-1 live contexts when
    the caller counted them on the host from the same tables
    (``live_contexts``, as ``decode_section_device`` does), or None to
    count them on the card."""
    global last_decode
    _check_order(order)
    off_np = _decode_offsets(payload, lane_counts, lanes, steps, offsets)
    _check_tables(freq_lut, cum_lut, order, sym_lut)
    if not _on_cuda(payload, lane_counts, sym_lut, freq_lut, cum_lut):
        return rans_decode_plain(payload, lane_counts, sym_lut, freq_lut,
                                 cum_lut, lanes, steps, order,
                                 offsets=offsets)
    lib = _build.library()
    dev = payload.device
    payload = payload.contiguous()
    counts = _aligned(lane_counts.long())
    if live is None:
        live = _live_of(freq_lut, order)
    shared = order == 0 or live <= decode_shared_rows()
    table, syms = decode_table(sym_lut, freq_lut, cum_lut, order,
                               live if shared else None)
    if syms is not None:
        syms = _aligned(syms)
    n = int(off_np[-1])
    out = torch.empty(n, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        _launch("rans_decode", lib.repaq_rans_decode, payload.data_ptr(),
                payload.shape[0], counts.data_ptr(), lanes, n,
                table.data_ptr(), None if syms is None else syms.data_ptr(),
                table.shape[0], int(shared), order, out.data_ptr(),
                _stream(dev))
    route = "shared" if shared else "global"
    decode_routes[route] += 1
    last_decode = (order, live, route)
    return _decode_result(out, lanes, steps, offsets)


# ---------------------------------------------------------------------------
# section drivers, byte-compatible with rans_np
# ---------------------------------------------------------------------------


def encode_section_device(data, order: int = 0,
                          lanes: int = rans_np.DEFAULT_LANES, *,
                          device) -> bytes:
    """Drop-in for rans_np.encode_section(data, order, lanes): the same
    bytes for every n, ragged lanes included, with the coder on `device`
    (a CUDA device launches the kernels; the CPU runs their plain
    versions). RfqzWriter takes it with the device bound
    (functools.partial)."""
    arr = _as_u8(data)
    n = arr.shape[0]
    lanes = max(1, min(lanes, n))
    if n == 0:
        return (bytes([order]) + (0).to_bytes(4, "little")
                + lanes.to_bytes(2, "little") + (0).to_bytes(4, "little"))
    head, freqs, cum = section_prologue(arr, order, lanes)
    dev = torch.device(device)
    payload, lane_bytes, total = rans_encode_payload_device(
        _to(arr, dev), _to(freqs.astype(np.int32), dev),
        _to(cum.astype(np.int32), dev), lanes, order,
        out_cap=2 * n + 4 * lanes + 8)
    total = int(total)
    return b"".join([head, total.to_bytes(4, "little"),
                     lane_bytes.cpu().numpy().astype("<u4").tobytes(),
                     payload[:total].cpu().numpy().tobytes()])


def parse_section(buf, off: int = 0):
    """The parts of the section at `off` of `buf`, checked as
    rans_np.decode_section checks them: (order, n, lanes, payload u8,
    lane counts int64, freqs, cum, sym_lut, offset past the section);
    n = 0 gives None for the arrays. A short buffer raises
    ``rans_np.RansTruncated`` (a ValueError; "rANS section truncated"
    past the tables, as the JAX module says), a bad lane table
    ValueError("rANS section lane table corrupt")."""
    buf = memoryview(buf)
    if len(buf) - off < 7:
        raise rans_np.RansTruncated("rANS section truncated (header)")
    order = 1 if buf[off] else 0
    n = int.from_bytes(buf[off + 1 : off + 5], "little")
    lanes = int.from_bytes(buf[off + 5 : off + 7], "little")
    off += 7
    if n == 0:
        if len(buf) - off < 4:
            raise rans_np.RansTruncated(
                "rANS section truncated (empty payload len)")
        return order, 0, lanes, None, None, None, None, None, off + 4
    if lanes < 1:
        raise ValueError("rANS section lane count corrupt (0 with n > 0)")
    freqs, cum, sym, off = _parse_tables(buf, off, order)
    payload_len = int.from_bytes(buf[off : off + 4], "little")
    off += 4
    if off + 4 * lanes + payload_len > len(buf):
        raise rans_np.RansTruncated("rANS section truncated")
    counts = np.frombuffer(buf, dtype="<u4", count=lanes,
                           offset=off).astype(np.int64)
    off += 4 * lanes
    payload = np.frombuffer(buf, dtype=np.uint8, count=payload_len,
                            offset=off)
    off += payload_len
    if (int(counts.sum()) != payload_len or (counts < 4).any()
            or ((counts - 4) % 2).any()):
        raise ValueError("rANS section lane table corrupt")
    return order, n, lanes, payload, counts, freqs, cum, sym, off


def decode_section_device(buf, off: int = 0, *, device) -> tuple[bytes, int]:
    """Drop-in for rans_np.decode_section(buf, off): (raw bytes, offset
    past the section), with the decoder on `device`. The section is
    checked before any launch (``parse_section``)."""
    order, n, lanes, payload, counts, freqs, cum, sym, off = parse_section(
        buf, off)
    if n == 0:
        return b"", off
    dev = torch.device(device)
    out = _rans_decode(
        _to(payload, dev), _to(counts, dev), _to(sym, dev),
        _to(freqs.astype(np.int32), dev), _to(cum.astype(np.int32), dev),
        lanes, 0, order, rans_np.lane_slices(n, lanes),
        live_contexts(freqs))
    return out.cpu().numpy().tobytes(), off
