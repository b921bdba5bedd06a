"""The .rfq token coders as torch tensor code on an explicit device: the
PyTorch port of repaq_tpu/ops/device_streams.py (the encode and decode
halves of the SE and the PE-interleaved paths, and the PE overlap search).

Each function keeps the name, the arguments and the int32 arithmetic of
its JAX twin, so the two can be fed the same input, and is byte-exact with
it and with repaq_tpu.codec.kernels_np. What differs from JAX:

- JAX's ``.at[idx].set(mode="drop")`` drops out-of-range indices, and
  its callers aim every masked write at one spare element past the end.
  Here the decode's writes (the quality runs, the escapes, the N
  positions' deltas and segment marks) are ``kernels.fill_runs``: masked
  entries and targets out of range write nothing, and a token's run is
  written whole, so neither the spare element nor JAX's (run_cap, 4, 31)
  run grid is needed.
- JAX's sorts either compact (the elements whose key is not the fill, in
  index order) or group (by bin id, then index); here both are
  ``kernels.bucket_compact``, one stable bucket compaction that also
  gathers a payload and counts each bucket. The payload is 0 past the kept
  elements, where JAX's rides its fill keys; every caller masks it there.
- After their grouping, the quality and N-position streams are written
  whole by one emission kernel each (``kernels.qualcol_emit``,
  ``kernels.positions_emit``: classification, run tokens, offsets, the
  length table and the escape records in one launch). The torch
  composition it replaced, JAX's chain of classification, token bytes,
  compaction of the multi-byte tokens and layout sort, stays below as the
  kernels' plain versions (``qualcol_emit_plain``, ``positions_emit_plain``
  over ``_classify_stream_positions``, ``_stream_b0``, ``_emit_sort_pay``
  and ``_emit_sort_lazy``), handed to ``kernels`` for CPU tensors.
- The coordinate streams are one kernel for both rows
  (``kernels.coords_emit``: classification, run tokens and offsets in one
  launch); the torch composition it replaced stays below as its plain
  version (``coords_emit_plain`` over ``_emit_sort``).
- JAX's layout sort, which places each candidate byte at its rank among
  the offsets, is a direct write of each byte at its offset
  (``kernels.fill_runs`` with count 1): the offsets are distinct and cover
  the stream, so rank and offset agree, and the coordinates need no filler
  keys.
- ``torch.cumsum`` is asked for int32 explicitly (it defaults to int64).
- The overlap search is ``kernels.overlap_pairs``, exact where JAX
  hashes: the CUDA kernel for CUDA tensors, its plain version for CPU
  tensors; it returns no collision flags.
- The decode's gap/run parse (the length table, the token FSM, the token
  compaction carrying each token's window, the token arithmetic, the bins
  and the segmented position sum, the escape records) is one kernel a
  stream (``kernels.qualcol_parse``, ``kernels.positions_parse``), whose
  output is each token's run (start, count). The torch composition it
  replaced stays below as the kernels' plain versions
  (``qualcol_parse_plain``, ``positions_parse_plain``), which call the
  token FSM ``kernels.token_start_mask``, ``kernels.bucket_compact`` and
  the segmented prefix sum ``kernels.seg_positions``, as
  ``decode_positions_device`` still does (it keeps JAX's signature for the
  tests and runs on no main path).
- The encode's run-boundary scan (JAX's ``lax.cummax`` and flipped
  ``lax.cummin`` with the arithmetic around them) is
  ``kernels.run_offsets`` (each element's offset in its run and the
  elements left of it, up to 32; the coordinates' two rows at once) in
  the emission kernels' plain versions.
"""

from __future__ import annotations

import torch

from . import kernels

_I32 = torch.int32
_INF = 2**31 - 1

# named ranges of the decode's writes in a torch.profiler trace (a flag
# test when no profiler runs); tools/profile_torch_pe.py reads them
_span = torch.profiler.record_function

def _arange(n: int, device, start: int = 0) -> torch.Tensor:
    return torch.arange(start, n, dtype=_I32, device=device)


def _scalar(v: int, device) -> torch.Tensor:
    return torch.tensor(v, dtype=_I32, device=device)


def _cumsum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    return torch.cumsum(x, dim, dtype=_I32)


def _exclusive_cumsum(x: torch.Tensor):
    c = _cumsum(x)
    return c, (c[-1] if x.shape[0] else _scalar(0, x.device))


def _shift1(x: torch.Tensor, first) -> torch.Tensor:
    """[first, x[0], ..., x[-2]]"""
    head = torch.full((1,), first, dtype=x.dtype, device=x.device)
    return torch.cat([head, x[:-1]])


def _gather1(arr: torch.Tensor, idx: torch.Tensor, fill=0) -> torch.Tensor:
    """Gather with one sentinel row appended (idx == len(arr) -> fill)."""
    ext = torch.cat([arr, torch.full((1,), fill, dtype=arr.dtype,
                                     device=arr.device)])
    return ext[idx.long()]


def _compact(mask: torch.Tensor, cap: int, fill: int,
             payload: torch.Tensor | None = None):
    """(idx, pay): the indices where the (n,) bool mask is set, ascending,
    cut to cap and filled with fill, and payload at them (0 past them)."""
    idx, pay, _counts = kernels.bucket_compact(mask, 1, cap, fill, payload)
    return idx, pay


# ---------------------------------------------------------------------------
# encode side: emission
# ---------------------------------------------------------------------------


def _write_stream(offs: list, bytes_: list, out_size: int, total):
    """Lay candidate bytes out at their destination offsets in a zeroed
    (out_size,) buffer, one write each. offs/bytes_: matching lists of
    int32 offset / byte arrays; invalid lanes carry offset INT32_MAX, which
    is past out_size and so writes nothing, as do valid offsets past it."""
    all_off = torch.cat(offs) if len(offs) > 1 else offs[0]
    all_b = torch.cat(bytes_) if len(bytes_) > 1 else bytes_[0]
    out = torch.zeros(out_size, dtype=torch.uint8, device=all_off.device)
    kernels.fill_runs(out, all_off, 1, all_b.to(torch.uint8))
    return out, total


def _emit_sort(planes: torch.Tensor, counts: torch.Tensor, out_size: int,
               offsets: torch.Tensor | None = None, total=None,
               multi_cap: int | None = None,
               extra_keys: torch.Tensor | None = None):
    """Stream emission of (n, W) candidate byte planes with per-element
    byte counts; every element contributes its first byte and the <=
    multi_cap elements emitting >= 2 bytes their other lanes. extra_keys:
    pre-built (offset << 8 | byte) keys to interleave. Returns (out,
    total_len)."""
    n, w = planes.shape
    dev = planes.device
    assert out_size < (1 << 30), "emission output beyond int32 offsets"
    explicit_total = total is not None
    if offsets is None:
        cum, derived = _exclusive_cumsum(counts)
        offsets = cum - counts
        if not explicit_total:
            total = derived
    elif not explicit_total:
        total = offsets[-1] + counts[-1] if n else _scalar(0, dev)
    offs = [torch.where(counts >= 1, offsets, _INF)]
    bytes_ = [planes[:, 0].to(_I32)]
    multi_cap = n if multi_cap is None else min(multi_cap, n)
    if w > 1 and multi_cap > 0:
        midx, _p = _compact(counts >= 2, multi_cap, n)
        mcounts = _gather1(counts, midx)
        moff = _gather1(offsets, midx)
        mplanes = torch.cat([planes, planes.new_zeros((1, w))])[midx.long()]
        lanes = _arange(w, dev, 1)[None, :]
        mvalid = lanes < mcounts[:, None]
        offs.append(torch.where(mvalid, moff[:, None] + lanes, _INF)
                    .reshape(-1))
        bytes_.append(mplanes[:, 1:].to(_I32).reshape(-1))
    if extra_keys is not None:
        offs.append(torch.where(extra_keys == _INF, _INF, extra_keys >> 8))
        bytes_.append(extra_keys & 0xFF)
        if not explicit_total:
            total = total + extra_keys.shape[0]
    return _write_stream(offs, bytes_, out_size, total)


def _emit_sort_pay(b0: torch.Tensor, counts: torch.Tensor, out_size: int,
                   offsets: torch.Tensor, total, multi_cap: int,
                   fields: torch.Tensor, w: int, extra=None,
                   first_mask: torch.Tensor | None = None):
    """Emission for gap/run streams: the multi-byte token fields
    ((delta << 2) | ttype, ttype 0/1/2 = 1/2/4-byte token) ride the
    compaction as payload, and their tail bytes are elementwise functions
    of the compacted pair. No escape tokens (see _emit_sort_lazy).
    extra: optional (offsets, bytes) to interleave."""
    assert out_size < (1 << 30), "emission output beyond int32 offsets"
    dev = b0.device
    n = b0.shape[0]
    multi_cap = max(1, min(multi_cap, n))
    first = counts >= 1 if first_mask is None else first_mask
    # the offsets ascend with i, so the multi-byte elements in index order
    # are JAX's (offset, field) pairs sorted by offset
    midx, sfield = _compact(counts >= 2, multi_cap, n, fields)
    skey = _gather1(offsets, midx, fill=_INF)
    svalid = skey < _INF
    st = sfield & 3
    v = (sfield >> 2) - 1
    scount = torch.where(st == 1, 2, torch.where(st == 2, 4, 1))
    b1 = torch.where(st == 1, v & 0xFF,
                     torch.where(st == 2, (v >> 16) & 0xFF, 0))
    b2 = torch.where(st == 2, (v >> 8) & 0xFF, 0)
    b3 = torch.where(st == 2, v & 0xFF, 0)
    lanes = _arange(w, dev, 1)[None, :]
    mvalid = svalid[:, None] & (lanes < scount[:, None])
    offs = [torch.where(first, offsets, _INF),
            torch.where(mvalid, skey[:, None] + lanes, _INF).reshape(-1)]
    tail = torch.stack([b1, b2, b3][: w - 1], dim=1).to(_I32)
    bytes_ = [b0.to(_I32), tail.reshape(-1)]
    if extra is not None:
        offs.insert(0, extra[0])
        bytes_.insert(0, extra[1])
    return _write_stream(offs, bytes_, out_size, total)


def _emit_sort_lazy(b0: torch.Tensor, counts: torch.Tensor, out_size: int,
                    offsets: torch.Tensor, total, multi_cap: int, tail_fn,
                    w: int, extra=None,
                    first_mask: torch.Tensor | None = None):
    """Emission without dense (n, W) byte planes: the elements emitting
    >= 2 bytes are compacted to multi_cap entries and tail_fn(midx) ->
    (multi_cap, w - 1) int32 gives their other lanes. extra: optional
    (offsets, bytes) to interleave (length tables, escape records)."""
    n = b0.shape[0]
    dev = b0.device
    assert out_size < (1 << 30), "emission output beyond int32 offsets"
    first = counts >= 1 if first_mask is None else first_mask
    multi_cap = max(1, min(multi_cap, n))
    midx, _p = _compact(counts >= 2, multi_cap, n)
    mcounts = _gather1(counts, midx)
    moff = _gather1(offsets, midx)
    tail = tail_fn(midx)
    lanes = _arange(w, dev, 1)[None, :]
    mvalid = lanes < mcounts[:, None]
    offs = [torch.where(first, offsets, _INF),
            torch.where(mvalid, moff[:, None] + lanes, _INF).reshape(-1)]
    bytes_ = [b0.to(_I32), tail.reshape(-1)]
    if extra is not None:
        offs.insert(0, extra[0])
        bytes_.insert(0, extra[1])
    return _write_stream(offs, bytes_, out_size, total)


# ---------------------------------------------------------------------------
# encode side: gap/run position streams
# ---------------------------------------------------------------------------


def _classify_stream_positions(g_pos: torch.Tensor, seg_start: torch.Tensor,
                               is_stream: torch.Tensor):
    """Gap/run token classification (reference rfqcodec.cpp:625-710) over
    grouped match positions, increasing within each segment; seg_start
    marks each segment's first element (`last` restarts at -1 there).
    Returns (delta, emits_run, covered, g1, g2, g4)."""
    delta = torch.where(seg_start, g_pos + 1, g_pos - _shift1(g_pos, -1))
    adj = is_stream & (delta == 1) & (g_pos > 1)
    # JAX's covered, min(32, run_len - off_in_run), is the elements left of
    # the run from each one on, up to 32: run_offsets' to_end
    off_in_run, covered = kernels.run_offsets(adj)
    emits_run = adj & (off_in_run % 32 == 0)
    gap = is_stream & ~adj
    g1 = gap & (delta <= 128)
    g2 = gap & (delta > 128) & (delta <= (1 << 14))
    g4 = gap & (delta > (1 << 14))
    return delta, emits_run, covered, g1, g2, g4


def _stream_b0(delta, emits_run, covered, g1, g2, g4):
    """(b0 first token byte, counts, ttype) for pure gap/run streams, all
    (m,) int32; ttype 0 = 1-byte, 1 = 2-byte gap, 2 = 4-byte gap."""
    counts = (g1.to(_I32) + 2 * g2.to(_I32) + 4 * g4.to(_I32)
              + emits_run.to(_I32))
    v = delta - 1
    b0 = torch.where(
        g1, v,
        torch.where(
            g2, (v >> 8) | 0x80,
            torch.where(
                g4, (v >> 24) | 0xE0,
                torch.where(emits_run, (covered - 1) | 0xC0, 0),
            ),
        ),
    ).to(_I32)
    ttype = torch.where(g2, 1, torch.where(g4, 2, 0)).to(_I32)
    return b0, counts, ttype


def qualcol_emit_plain(g_pos: torch.Tensor, bin_counts: torch.Tensor,
                       qual: torch.Tensor, nbins: int, esc_cap: int,
                       out_size: int):
    """Plain torch version of ``kernels.qualcol_emit``: the torch
    composition the kernel replaces (the classification, token bytes,
    escape gather, length table and emitters above); the wrapper runs it
    on CPU tensors."""
    dev = qual.device
    n = qual.shape[0]
    m = g_pos.shape[0]
    bin_start = torch.cat([torch.zeros(1, dtype=_I32, device=dev),
                           _cumsum(bin_counts)])
    # each grouped element's bin: one step up at each bin's end (the fill
    # past the kept ones reads B + 1, as JAX's fill keys do)
    step = torch.zeros(m + 1, dtype=_I32, device=dev).index_add_(
        0, bin_start[1:].clamp(max=m).long(),
        torch.ones(nbins + 1, dtype=_I32, device=dev))
    g_bid = _cumsum(step[:m])
    is_stream = g_bid < nbins
    is_esc = g_bid == nbins

    seg_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                           g_bid[1:] != g_bid[:-1]])
    delta, emits_run, covered, g1, g2, g4 = _classify_stream_positions(
        g_pos, seg_start, is_stream
    )
    b0, counts, ttype = _stream_b0(delta, emits_run, covered, g1, g2, g4)
    counts = counts + 5 * is_esc.to(_I32)
    ttype = torch.where(is_esc, 3, ttype).to(_I32)

    # bins (then escapes) are grouped in wire order, so the exclusive
    # prefix sum of counts is the stream offset after the 4B length table
    cum = _cumsum(counts)
    dest = 4 * nbins + (cum - counts)
    total = 4 * nbins + cum[-1]

    if esc_cap == 0:
        esc_off = torch.zeros(0, dtype=_I32, device=dev)
        esc_byte = torch.zeros(0, dtype=_I32, device=dev)
    else:
        # the grouping put the escapes in one run of g from the escape
        # bucket's start: JAX compacts them with a sort, here they are
        # indexed (m past the run, as JAX's fill)
        e = _arange(max(1, min(esc_cap, m)), dev) + bin_start[nbins]
        eidx = torch.where(e < torch.clamp(bin_start[nbins + 1], max=m), e,
                           m)
        e_pos = _gather1(g_pos, eidx, fill=0)
        e_dest = _gather1(dest, eidx, fill=-1)
        e_valid = _gather1(is_esc.to(_I32), eidx) == 1
        esc_byte = qual[e_pos.clamp(0, n - 1).long()].to(_I32)
        esc_off = torch.where(e_valid, e_dest, _INF)

    def tail(midx):
        t = _gather1(ttype, midx)
        v = _gather1(delta, midx) - 1
        p = _gather1(g_pos, midx)
        b1 = torch.where(t == 1, v & 0xFF,
                         torch.where(t == 2, (v >> 16) & 0xFF,
                                     torch.where(t == 3, p & 0xFF, 0)))
        b2 = torch.where(t == 2, (v >> 8) & 0xFF,
                         torch.where(t == 3, (p >> 8) & 0xFF, 0))
        b3 = torch.where(t == 2, v & 0xFF,
                         torch.where(t == 3, (p >> 16) & 0xFF, 0))
        b4 = torch.where(t == 3, (p >> 24) & 0xFF, 0)
        return torch.stack([b1, b2, b3, b4], dim=1).to(_I32)

    # per-bin byte lengths for the u32le table: each bin is a contiguous
    # run of g, cut at m, and its length a difference of the counts prefix
    # sum at the run boundaries
    bounds = bin_start[:nbins + 1].clamp(max=m).long()
    cumz = torch.cat([torch.zeros(1, dtype=_I32, device=dev), cum])
    lens = cumz[bounds[1:]] - cumz[bounds[:-1]]
    hdr = torch.stack([lens & 0xFF, (lens >> 8) & 0xFF, (lens >> 16) & 0xFF,
                       (lens >> 24) & 0xFF], dim=1).to(_I32).reshape(-1)
    hdr_off = _arange(4 * nbins, dev)

    # multi-byte elements: per bin the gap deltas sum to <= n, so 2- and
    # 4-byte gaps number < n/128 + n/16384 per bin; escapes <= esc_cap
    multi_cap = min(m, nbins * (n // 128 + n // 16384 + 8) + esc_cap)
    if esc_cap == 0:
        out, _ = _emit_sort_pay(
            b0, counts, out_size, dest, total, multi_cap,
            fields=(delta << 2) | ttype, w=4, extra=(hdr_off, hdr),
            first_mask=counts >= 1,
        )
        return out, total
    out, _ = _emit_sort_lazy(
        b0, counts, out_size, dest, total, multi_cap, tail, w=5,
        extra=(torch.cat([hdr_off, esc_off]), torch.cat([hdr, esc_byte])),
        first_mask=(counts >= 1) & ~is_esc,
    )
    return out, total


def positions_emit_plain(g_pos: torch.Tensor, n: int, out_size: int):
    """Plain torch version of ``kernels.positions_emit``: the torch
    composition the kernel replaces (the classification, token bytes and
    emitter above)."""
    pos_cap = g_pos.shape[0]
    i = _arange(pos_cap, g_pos.device)
    delta, emits_run, covered, g1, g2, g4 = _classify_stream_positions(
        g_pos, i == 0, g_pos < n
    )
    b0, counts, ttype = _stream_b0(delta, emits_run, covered, g1, g2, g4)
    cum, total = _exclusive_cumsum(counts)
    return _emit_sort_pay(
        b0, counts, out_size, cum - counts, total,
        min(pos_cap, n // 64 + 4), fields=(delta << 2) | ttype, w=4,
    )


def _positions_from_gpos(g_pos: torch.Tensor, n: int, out_size: int,
                         pos_cap: int):
    """The gap/run stream of the sorted (pos_cap,) candidate positions (n =
    invalid fill); (out, length). One ``kernels.positions_emit`` call."""
    assert g_pos.shape[0] == pos_cap
    return kernels.positions_emit(g_pos, n, out_size)


def _flag_positions(flag: torch.Tensor, n: int,
                    pos_cap: int) -> torch.Tensor:
    """The ascending (pos_cap,) int32 positions < n where flag is set,
    filled with n (JAX compacts groups of flags first when they are
    sparse, then sorts; one compaction gives the same positions)."""
    return _compact(flag[:n], pos_cap, n)[0]


def encode_positions_from_meta(meta: torch.Tensor, n: int, out_size: int,
                               pos_cap: int | None = None):
    """Gap/run stream of the 'N' positions (< n) flagged in bit 7 of the
    frontend's meta bytes: the byte-form counterpart of JAX's
    encode_positions_from_meta32. pos_cap: upper bound on the number of
    Ns (the engine knows it exactly). Returns (out (out_size,) u8, len)."""
    pos_cap = max(1, min(n if pos_cap is None else pos_cap, n))
    g_pos = _flag_positions(meta[:n] >= 0x80, n, pos_cap)
    return _positions_from_gpos(g_pos, n, out_size, pos_cap)


def encode_positions_from_mask(mask: torch.Tensor, out_size: int,
                               pos_cap: int | None = None):
    """Gap/run stream of the True positions of the (n,) bool mask (JAX's
    encode_positions_from_mask, the PE encode's N-position stream).
    pos_cap: upper bound on the number of True positions (default n).
    Returns (out (out_size,) u8, length)."""
    n = mask.shape[0]
    pos_cap = max(1, min(n if pos_cap is None else pos_cap, n))
    g_pos = _flag_positions(mask, n, pos_cap)
    return _positions_from_gpos(g_pos, n, out_size, pos_cap)


# ---------------------------------------------------------------------------
# encode side: by-column quality, coordinates
# ---------------------------------------------------------------------------


def qualcol_encode_device(meta: torch.Tensor | None, qual: torch.Tensor,
                          nbins: int, esc_cap: int | None = None,
                          nonmajor_cap: int | None = None,
                          out_size: int | None = None,
                          bid: torch.Tensor | None = None):
    """By-column quality encode (reference rfqcodec.cpp:712-765) from the
    frontend's bin ids: u32le per-bin lengths, the per-bin gap/run
    streams, then 5-byte escape records (char + u32le position).

    meta: (n,) u8 (bin id in bits 0-6: 0..B-1 stream, B escape, B+1
    major), or None with bid: (n,) int bin ids in the same space (the
    byte-form frontend's output, JAX's bid= form); qual: (n,) u8, read
    only at escapes. esc_cap / nonmajor_cap: upper bounds on escape
    records and on non-major positions (default n); esc_cap == 0 skips the
    escape machinery. Returns (out (out_size,) u8, total_len)."""
    n = qual.shape[0]
    if esc_cap is None:
        esc_cap = n
    nonmajor_cap = max(1, min(n if nonmajor_cap is None else nonmajor_cap,
                              n))
    if not nbins + 2 < 127:
        raise ValueError("qualcol device path needs B < 125")
    m = nonmajor_cap
    # one compaction groups the emitting positions by bin (the streams,
    # then the escapes, bucket B) and drops the major ones (B + 1); JAX
    # sorts the keys bid << 24 | pos for the same order
    bid = meta & 0x7F if bid is None else bid.to(torch.uint8)
    g_pos, _p, bin_counts = kernels.bucket_compact(bid, nbins + 1, m, n)
    if out_size is None:
        out_size = 4 * nbins + n + 8
    # the length table, the bins' tokens and the escape records: one
    # emission kernel from the grouping
    return kernels.qualcol_emit(g_pos, bin_counts, qual, nbins, esc_cap,
                                out_size)


def coords_emit_plain(v: torch.Tensor, out_cap: int, n_valid=None):
    """Plain torch version of ``kernels.coords_emit``: the torch
    composition the kernel replaces (the classification, the run offsets,
    the byte planes and the emitter above); the wrapper runs it on CPU
    tensors."""
    R, n = v.shape
    dev = v.device
    prev = torch.cat([torch.full((R, 1), 1000, dtype=_I32, device=dev),
                      v[:, :-1]], dim=1)
    diff = v - prev
    is_rep = diff == 0
    is_delta = (diff > 0) & (diff <= 64)
    is_abs2 = ~is_rep & ~is_delta & (v <= 32767)
    is_abs3 = ~is_rep & ~is_delta & (v > 32767)
    if n_valid is not None:
        valid = _arange(n, dev)[None, :] < n_valid
        is_rep = is_rep & valid
        is_delta = is_delta & valid
        is_abs2 = is_abs2 & valid
        is_abs3 = is_abs3 & valid

    off_in_rep, to_end = kernels.run_offsets(is_rep)
    kk = off_in_rep + 1
    full32 = is_rep & (kk % 32 == 0)
    # JAX's kk == rep_len: the repeat's last element, whose kk is rep_len;
    # rem (JAX: rep_len % 32) is read only there
    is_last = is_rep & (to_end == 1) & (kk % 32 != 0)
    counts = (is_delta.to(_I32) + 2 * is_abs2.to(_I32)
              + 3 * is_abs3.to(_I32) + full32.to(_I32) + is_last.to(_I32))
    rem = kk % 32
    first_b = torch.where(
        full32, 0xC0 | 31,
        torch.where(
            is_last, (rem - 1) | 0xC0,
            torch.where(
                is_delta, (diff - 1) | 0x80,
                torch.where(is_abs2, v >> 8,
                            torch.where(is_abs3, (v >> 16) | 0xE0, 0)),
            ),
        ),
    )
    second_b = torch.where(is_abs2, v & 0xFF,
                           torch.where(is_abs3, (v >> 8) & 0xFF, 0))
    third_b = torch.where(is_abs3, v & 0xFF, 0)

    cum = _cumsum(counts, dim=1)
    totals = cum[:, -1]
    row_base = (out_cap * _arange(R, dev))[:, None]
    offsets = row_base + cum - counts
    planes = (torch.stack([first_b, second_b, third_b], dim=2) & 0xFF).to(
        torch.uint8).reshape(R * n, 3)
    # each row's bytes land at their offsets; its tail [total_row, out_cap)
    # stays zero
    out, _ = _emit_sort(
        planes, counts.reshape(-1), R * out_cap,
        offsets=offsets.reshape(-1), total=R * out_cap,
    )
    assert R == 2
    return out, totals[0], totals[1]


kernels.register_emit_plain(qualcol_emit_plain, positions_emit_plain,
                            coords_emit_plain)


def coords_encode2_device(values2: torch.Tensor, out_cap: int,
                          n_valid=None):
    """Both coordinate streams (reference rfqcodec.cpp:1262-1330) of a
    chunk in one pass. values2: (2, B) int (row 0 = X, row 1 = Y); entries
    at i >= n_valid emit nothing and end repeat runs. Returns (out
    (2*out_cap,) u8 with X at [0, x_len) and Y at [out_cap, out_cap +
    y_len), x_len, y_len). One ``kernels.coords_emit`` call."""
    return kernels.coords_emit(values2.to(_I32), out_cap, n_valid)


# ---------------------------------------------------------------------------
# decode side
# ---------------------------------------------------------------------------


def _stream_lens_device(buf: torch.Tensor) -> torch.Tensor:
    """Per-byte token length for the gap/run stream grammar (valid only at
    token starts): 0xxxxxxx=1, 10xxxxxx=2, 110xxxxx=1, 111xxxxx=4, as
    uint8 (the token FSM reads a byte per length)."""
    b = buf.to(_I32)
    return torch.where(
        b < 0x80, 1, torch.where(b < 0xC0, 2, torch.where(b < 0xE0, 1, 4))
    ).to(torch.uint8)


def _window32(buf: torch.Tensor) -> torch.Tensor:
    """Little-endian int32 of the 4 bytes starting at each byte (wrapping
    at the end, as jnp.roll does)."""
    return (buf.to(_I32)
            | (torch.roll(buf, -1).to(_I32) << 8)
            | (torch.roll(buf, -2).to(_I32) << 16)
            | (torch.roll(buf, -3).to(_I32) << 24))


def _token_dist(b0, b1, b2, b3):
    """Gap distance of a token from its first four bytes (runs advance 1
    per covered position)."""
    is_gap1 = b0 < 0x80
    is_gap2 = (b0 >= 0x80) & (b0 < 0xC0)
    is_run = (b0 >= 0xC0) & (b0 < 0xE0)
    is_gap4 = b0 >= 0xE0
    dist = torch.where(
        is_gap1, b0 + 1,
        torch.where(
            is_gap2, (((b0 & 0x3F) << 8) | b1) + 1,
            torch.where(
                is_gap4, (((b0 & 0x1F) << 24) | (b1 << 16) | (b2 << 8) | b3)
                + 1,
                1,
            ),
        ),
    )
    return dist, is_run


def decode_positions_device(buf: torch.Tensor, valid_len, max_positions: int,
                            force_start: torch.Tensor | None = None):
    """Decode a gap/run stream (reference rfqcodec.cpp:957-1007).

    buf: (m,) u8 padded with >= 4 zero bytes beyond valid_len; tokens live
    in [0, valid_len). Returns (positions (max_positions,) int32 padded
    with -1, count). Positions restart at -1 wherever force_start is
    True."""
    m = buf.shape[0]
    dev = buf.device
    in_range = _arange(m, dev) < valid_len
    lens = torch.where(in_range, _stream_lens_device(buf), 1)
    starts = kernels.token_start_mask(lens, force_start) & in_range

    w32 = _window32(buf)
    b0 = w32 & 0xFF
    dist, is_run = _token_dist(b0, (w32 >> 8) & 0xFF, (w32 >> 16) & 0xFF,
                               (w32 >> 24) & 0xFF)
    npos_tok = torch.where(starts, torch.where(is_run, (b0 & 0x1F) + 1, 1),
                           0).to(_I32)

    # expand tokens to per-position deltas (dist at each token's first
    # position, 1 within runs); positions = cumsum(deltas) - 1
    cum_pos = _cumsum(npos_tok)
    count = cum_pos[-1] if m else _scalar(0, dev)
    first_slot = cum_pos - npos_tok
    with _span("dec.npos.write"):
        deltas = torch.ones(max_positions, dtype=_I32, device=dev)
        kernels.fill_runs(deltas, first_slot, 1, dist.to(_I32), starts)
    if force_start is not None:
        # a segment restarts its running position at -1: subtract the
        # running total just before each segment start
        seg_mark = torch.zeros(max_positions, dtype=torch.bool, device=dev)
        kernels.fill_runs(seg_mark, first_slot, 1, True,
                          starts & force_start)
        positions = kernels.seg_positions(deltas, seg_mark)
    else:
        positions = _cumsum(deltas) - 1
    k = _arange(max_positions, dev)
    return torch.where(k < count, positions, -1), count


def _escape_records(buf, w32, stream_end, total_len: int, esc_cap: int):
    """(pos, char) of the first esc_cap 5-byte escape records from
    stream_end: (esc_cap,) int32 positions, -1 for a record past
    total_len, and (esc_cap,) u8 chars, 0 there."""
    m = buf.shape[0]
    dev = buf.device
    rec = stream_end + 5 * _arange(esc_cap, dev)
    rec_ok = (rec + 4) < total_len
    recc = rec.clamp(max=m - 5)
    we = torch.cat([w32, torch.zeros(3, dtype=_I32, device=dev)])[recc.long()]
    ch = (we & 0xFF).to(torch.uint8)
    pos = ((we >> 8) & 0xFFFFFF) | (
        buf[(recc + 4).clamp(max=m - 1).long()].to(_I32) << 24)
    return torch.where(rec_ok, pos, -1), torch.where(rec_ok, ch, 0)


def _scatter_escapes(qual, esc_pos, esc_char):
    """Write the escape records' chars into the (length,) qual; a position
    outside it (-1 for no record) writes nothing."""
    kernels.fill_runs(qual, esc_pos, 1, esc_char)


def _tokens(starts, w32, cap: int):
    """(tok_i, n_tok, npos, adv) of the first cap tokens of a start mask:
    one compaction carrying each token's 4-byte window, then the per-token
    gap/run arithmetic (npos and adv 0 past the tokens)."""
    tok_i, tok_w, n_tok = kernels.bucket_compact(starts, 1, cap, _INF, w32)
    valid = tok_i < _INF
    b0 = tok_w & 0xFF
    dist, is_run = _token_dist(b0, (tok_w >> 8) & 0xFF, (tok_w >> 16) & 0xFF,
                               (tok_w >> 24) & 0xFF)
    npos = torch.where(valid, torch.where(is_run, (b0 & 0x1F) + 1, 1),
                       0).to(_I32)
    adv = torch.where(valid, dist + npos - 1, 0).to(_I32)
    return tok_i, n_tok, npos, adv


def _runs(npos, adv, seg_start):
    """Each token's first position from the segmented position sum (0
    where it covers none)."""
    pos_end = kernels.seg_positions(adv, seg_start)
    return torch.where(npos > 0, pos_end - npos + 1, 0)


def qualcol_parse_plain(buf: torch.Tensor, qual_len: int, nbins: int,
                        tok_cap: int, esc_cap: int):
    """Plain torch version of ``kernels.qualcol_parse``: the torch
    composition the kernel replaces (the length table and forced restarts,
    the token FSM, the token compaction carrying each token's window, the
    token arithmetic, the bin search and the segmented position sum, the
    escape records); the wrapper runs it on CPU tensors."""
    m = buf.shape[0]
    dev = buf.device
    lens_table = (buf[0: 4 * nbins: 4].to(_I32)
                  | (buf[1: 4 * nbins + 1: 4].to(_I32) << 8)
                  | (buf[2: 4 * nbins + 2: 4].to(_I32) << 16)
                  | (buf[3: 4 * nbins + 3: 4].to(_I32) << 24))
    cum_lens = _cumsum(lens_table)
    stream_begin = 4 * nbins + cum_lens - lens_table  # (B,)
    stream_end = 4 * nbins + (cum_lens[-1] if nbins else _scalar(0, dev))

    idx = _arange(m, dev)
    in_streams = (idx >= 4 * nbins) & (idx < stream_end)
    force = torch.zeros(m + 1, dtype=torch.bool, device=dev)
    force[stream_begin.clamp(0, m).long()] = True
    force = force[:m] & in_streams

    lens_dev = torch.where(in_streams, _stream_lens_device(buf), 1)
    starts = kernels.token_start_mask(lens_dev, force) & in_streams
    w32 = _window32(buf)
    tok_i, n_tok, npos, adv = _tokens(starts, w32, tok_cap)

    # bin id per token and segment starts (per-bin `last` restarts at -1)
    tok_bin = (torch.searchsorted(stream_begin, tok_i, right=True) - 1).clamp(
        0, max(nbins - 1, 0)).to(_I32)
    seg_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                           tok_bin[1:] != tok_bin[:-1]])
    start = _runs(npos, adv, seg_start)
    # the bins are the segments, in token order: tok_bin never falls (tok_i
    # rises and a binary search's answer rises with its query, sorted table
    # or not), so bin s is the tokens from the first with tok_bin >= s, and
    # the valid count ends the last
    seg_off = torch.minimum(
        torch.searchsorted(tok_bin, _arange(nbins + 1, dev), out_int32=True),
        n_tok.clamp(max=tok_cap))
    esc_pos, esc_char = _escape_records(buf, w32, stream_end, qual_len,
                                        esc_cap)
    return start, npos, seg_off, esc_pos, esc_char


def positions_parse_plain(buf: torch.Tensor, valid_len: int, cap: int):
    """Plain torch version of ``kernels.positions_parse``: the torch
    composition of decode_positions_device up to its tokens (the token
    FSM, the token compaction, the token arithmetic, the position sum),
    its runs in token space."""
    m = buf.shape[0]
    dev = buf.device
    in_range = _arange(m, dev) < valid_len
    lens = torch.where(in_range, _stream_lens_device(buf), 1)
    starts = kernels.token_start_mask(lens) & in_range
    _tok_i, _n, npos, adv = _tokens(starts, _window32(buf), cap)
    return _runs(npos, adv, _arange(cap, dev) == 0), npos


kernels.register_parse_plain(qualcol_parse_plain, positions_parse_plain)


def qualcol_decode_device(buf: torch.Tensor, nbins: int, bins: torch.Tensor,
                          major: int, length: int, total_len,
                          tok_cap: int | None = None,
                          pos_cap: int | None = None,
                          esc_cap: int | None = None,
                          run_cap: int | None = None) -> torch.Tensor:
    """By-column quality decode (reference rfqcodec.cpp:1009-1047): the
    stream's runs from one parse (``kernels.qualcol_parse``: on a card one
    kernel for the token FSM over the concatenated per-bin streams, stream
    boundaries forcing restarts, the token compaction, the per-token
    gap/run arithmetic and the bins), then the writes of each token's run
    of (position -> bin char) over the major, the bins as sorted segments
    (``kernels.fill_sorted_runs``), then of the escape records
    (``kernels.fill_runs``).

    buf: (m,) u8 padded with >= 5 zero bytes; total_len: true qual_buf
    size. tok_cap / esc_cap: upper bounds on token and escape-record
    counts. pos_cap and run_cap keep JAX's signature and select nothing
    here: JAX picks its slot-space rebuild (a delta scattered at each
    token's first slot, one cumsum, pos_cap slots) when run_cap is None,
    else token-space writes with a (run_cap, 4, 31) grid extending the
    runs; both give these bytes while the caps hold the chunk's counts.
    Returns qual (length,) u8."""
    m = buf.shape[0]
    tok_cap = max(1, min(m if tok_cap is None else tok_cap, m))
    if esc_cap is None:
        esc_cap = m // 5 + 1
    start, count, seg_off, esc_pos, esc_char = kernels.qualcol_parse(
        buf, int(total_len), nbins, tok_cap, esc_cap)
    with _span("dec.qual.fill"):
        qual = kernels.fill_sorted_runs(length, int(major), start, count,
                                        seg_off, bins.to(torch.uint8))
    if esc_cap > 0:
        # a second launch, so that an escape lands over a stream's write
        with _span("dec.qual.esc"):
            _scatter_escapes(qual, esc_pos, esc_char)
    return qual


# ---------------------------------------------------------------------------
# PE overlap search (reference rfqcodec.cpp:1391-1438)
# ---------------------------------------------------------------------------


def overlap_pairs_device(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """First exact overlap per pair (reference semantics: +o forward, r1
    suffix == r2 prefix, then -o backward, first match from o = 12 up; 0
    none). r1: (p, L1) u8, r2: (p, L2) u8, already reverse-complemented.

    Returns ov, (p,) int32, JAX's ov. The search is exact
    (``kernels.overlap_pairs``: the CUDA kernel on the card, its plain
    version on the CPU), so JAX's collision flags have no counterpart. It
    keeps JAX's signature for the tests: the engine's PE step runs the same
    search inside ``kernels.pe_encode_pairs``, with the revcomp and the
    shift clamp."""
    return kernels.overlap_pairs(r1, r2)
