"""The encode's gap/run token emission (kernels.qualcol_emit and
kernels.positions_emit; csrc/emit.cu on a card, their plain torch versions
here) against the JAX package's stream coders (repaq_tpu/ops/
device_streams.py: qualcol_encode_device in its meta32 form,
_positions_from_gpos, encode_positions_from_meta32), the host coders
(repaq_tpu.codec.kernels_np: encode_qual_by_col, encode_positions) and
chip_smoke.emit_ref, a numpy loop over the grammar. The cases are
chip_smoke's EMIT_CASES and POS_CASES, placed at the kernel's quality tile of
4,096 grouped elements: 1 and 124 bins with empty ones, runs of 31, 32, 33 and
65 and across tile edges, gaps of 128/129, 16384/16385 and 2^29, escapes
and esc_cap 0 without them, caps at and below the count, an output shorter
than the stream. Everything is integer: the tolerance is exact equality of
the whole output buffers and the totals."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repaq_tpu.codec import kernels_np as K
from repaq_tpu.codec import vectorized
from repaq_tpu.ops import device_streams as D
from repaq_tpu_torch.codec.device_engine import DeviceEngine
from repaq_tpu_torch.ops import device_streams as T
from repaq_tpu_torch.ops import kernels as TK

from chip_smoke import (EMIT_CASES, POS_CASES, emit_args, emit_pos_case,
                        emit_quality_case, emit_ref)
from test_device_engine import _mk_block
from test_torch_reference import jax_native  # noqa: F401

# repaq_tpu's native code runs from its source built for this CPU
pytestmark = pytest.mark.usefixtures("jax_native")

TILE = 4096  # csrc/emit.cu's quality tile (kernels.emit_tile on a card)
# cases whose caps cut the stream (the host coders code it whole), and the
# one whose positions need a 2^29-byte buffer (held at g_pos level)
CUT = ("cap_cut",)
DIRECT = ("gap_2_29", "pos_2_29")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pad4(a, fill):
    pad = (-a.shape[0]) % 4
    return np.concatenate([a, np.full(pad, fill, a.dtype)])


@pytest.mark.parametrize("name", EMIT_CASES + POS_CASES)
def test_emit_plain_matches_the_numpy_loop(name):
    """Each case at the kernel's interface: the wrapper on CPU tensors (its
    plain version) equal to chip_smoke.emit_ref, buffer and total, and no
    launch counted."""
    entry, args = emit_args(name, TILE)
    before = dict(TK.launches)
    out, total = getattr(TK, entry)(*args)
    assert TK.launches == before
    assert out.dtype == torch.uint8 and out.shape == (args[-1],)
    rout, rtotal = emit_ref(entry, args)
    assert int(total) == rtotal
    assert np.array_equal(out.numpy(), rout)


@pytest.mark.parametrize("name", [c for c in EMIT_CASES
                                  if c not in DIRECT])
def test_qualcol_cases_match_jax_and_host(name):
    """qualcol_encode_device through qualcol_emit against the JAX
    package's meta32 form (the engine's caps) and the host coder."""
    c = emit_quality_case(name, TILE)
    out_size = emit_args(name, TILE)[1][-1]
    nbins, major = c["nbins"], c["major"]
    qual = _pad4(c["qual"], major)
    meta = _pad4(c["meta"], nbins + 1)
    n = qual.shape[0]
    caps = dict(esc_cap=c["esc_cap"], nonmajor_cap=c["nm_cap"],
                out_size=out_size)
    got, ln = T.qualcol_encode_device(_t(meta), _t(qual), nbins, **caps)
    want, wln = jax.jit(lambda tb, m32, q32: D.qualcol_encode_device(
        None, tb, major, None, meta32=m32, qual32=q32, n=n, **caps))(
        jnp.asarray(c["table"]), jnp.asarray(meta.view("<u4")),
        jnp.asarray(qual.view("<u4")))
    assert int(ln) == int(wln)
    assert np.array_equal(got.numpy(), np.asarray(want))
    if name not in CUT:
        host = K.encode_qual_by_col(qual, c["table"], major).tobytes()
        assert int(ln) == len(host)
        keep = min(len(host), out_size)
        assert bytes(got.numpy()[:keep]) == host[:keep]
        assert not got.numpy()[keep:].any()


@pytest.mark.parametrize("name", [c for c in POS_CASES if c not in DIRECT])
def test_positions_cases_match_jax_and_host(name):
    """encode_positions_from_meta through positions_emit against JAX's
    encode_positions_from_meta32 and _positions_from_gpos, and the host
    coder."""
    c = emit_pos_case(name, TILE)
    out_size = emit_args(name, TILE)[1][-1]
    mask = _pad4(c["mask"], False)
    n, pos_cap = mask.shape[0], c["pos_cap"]
    meta = mask.astype(np.uint8) << 7
    got, ln = T.encode_positions_from_meta(_t(meta), n, out_size, pos_cap)
    want, wln = jax.jit(lambda m32: D.encode_positions_from_meta32(
        m32, n, out_size, pos_cap=pos_cap))(jnp.asarray(meta.view("<u4")))
    assert int(ln) == int(wln)
    assert np.array_equal(got.numpy(), np.asarray(want))
    g = np.full(pos_cap, n, np.int32)
    pos = np.flatnonzero(mask)
    g[:pos.shape[0]] = pos
    direct, dln = T.positions_emit_plain(_t(g), n, out_size)
    jdirect, jdln = jax.jit(lambda gp: D._positions_from_gpos(
        gp, n, out_size, pos_cap))(jnp.asarray(g))
    assert int(dln) == int(jdln) == int(ln)
    assert np.array_equal(direct.numpy(), np.asarray(jdirect))
    host = K.encode_positions(pos).tobytes()
    assert int(ln) == len(host)
    keep = min(len(host), out_size)
    assert bytes(got.numpy()[:keep]) == host[:keep]


def test_gaps_of_2_29():
    """4-byte gaps of 2^29 in both streams, straight from the grouped
    positions (no 2^29-byte buffer): the N stream against JAX's
    _positions_from_gpos and the host coder, the quality stream's bins
    against the host coder's per-bin streams behind their length table."""
    entry, args = emit_args("pos_2_29", TILE)
    g, n, out_size = args
    got, ln = TK.positions_emit(*args)
    want, wln = jax.jit(lambda gp: D._positions_from_gpos(
        gp, n, out_size, g.shape[0]))(jnp.asarray(g.numpy()))
    assert int(ln) == int(wln)
    assert np.array_equal(got.numpy(), np.asarray(want))
    pos = g.numpy()[g.numpy() < n]
    assert bytes(got.numpy()[:int(ln)]) == K.encode_positions(pos).tobytes()

    entry, args = emit_args("gap_2_29", TILE)
    g, counts, _qual, nbins, _esc, out_size = args
    got, ln = TK.qualcol_emit(*args)
    bounds = np.concatenate([[0], np.cumsum(counts.numpy())])
    streams = [K.encode_positions(g.numpy()[bounds[b]:bounds[b + 1]])
               .tobytes() for b in range(nbins)]
    host = b"".join(len(s).to_bytes(4, "little") for s in streams) + \
        b"".join(streams)
    assert int(ln) == len(host)
    assert bytes(got.numpy()[:int(ln)]) == host
    assert b"\xff" * 4 in streams[0]  # the gap of 2^29: v = 2^29 - 1


def test_escape_records_and_their_chars():
    """The escapes' records (char, u32le position) after the bins: the
    first esc_cap escapes get their char, every record its position; with
    esc_cap 0 a record is 5 zero bytes (the bytes the torch composition
    writes; the engine passes esc_cap 0 only without escapes)."""
    entry, args = emit_args("esc_edge", TILE)
    g, counts, qual, nbins, esc_cap, out_size = args
    n_esc = int(counts[nbins])
    full, total = TK.qualcol_emit(*args)
    rec = full.numpy()[int(total) - 5 * n_esc:int(total)].reshape(-1, 5)
    esc_pos = g.numpy()[int(counts[:nbins].sum()):][:n_esc]
    assert np.array_equal(rec[:, 0], qual.numpy()[esc_pos])
    assert np.array_equal(rec[:, 1:].copy().view("<u4")[:, 0], esc_pos)
    for cap in (n_esc - 2, 0):
        out, tot = TK.qualcol_emit(g, counts, qual, nbins, cap, out_size)
        assert int(tot) == int(total)
        r = out.numpy()[int(tot) - 5 * n_esc:int(tot)].reshape(-1, 5)
        assert np.array_equal(r[:cap, 0], rec[:cap, 0])
        assert not r[cap:, 0].any()
        assert np.array_equal(r[:, 1:], rec[:, 1:] if cap else 0 * rec[:, 1:])
        rout, rtot = emit_ref(entry, [g, counts, qual, nbins, cap, out_size])
        assert rtot == int(tot) and np.array_equal(out.numpy(), rout)


@pytest.mark.parametrize("pe", [False, True])
def test_engine_chunk_through_the_emission(pe, monkeypatch):
    """One SE chunk (with Ns and escape records) and one PE chunk through
    DeviceEngine("cpu", min_bases=0): bytes equal to vectorized's, the
    input back, and each stream one call of its emission entry."""
    calls = {"qualcol_emit": 0, "positions_emit": 0}
    for name in calls:
        def counted(*a, _name=name, _fn=getattr(TK, name)):
            calls[_name] += 1
            return _fn(*a)
        monkeypatch.setattr(TK, name, counted)
    eng = DeviceEngine("cpu", min_bases=0)
    if pe:
        block = _mk_block(600, 96, seed=7, pe_overlap=0.5, nfrac=0.01)
        header = vectorized.make_header_pe(block)
    else:
        header = vectorized.make_header_se(_mk_block(400, 80, seed=5))
        block = _mk_block(400, 80, seed=6, esc=True, nfrac=0.01)
    got = eng.encode_chunk(header, block, pe)
    assert got.to_bytes() == vectorized.encode_chunk(header, block,
                                                     pe).to_bytes()
    assert calls == {"qualcol_emit": 1, "positions_emit": 1}
    back = eng.decode_chunk(header, got)
    assert np.array_equal(back.seq_flat, block.seq_flat)
    assert np.array_equal(back.qual_flat, block.qual_flat)
    assert eng.stats["device_chunks"] == 1 == eng.stats["device_decodes"]


@pytest.mark.parametrize("bad", ["gpos_dtype", "gpos_empty", "nbins125",
                                 "counts_shape", "out_below_table",
                                 "out_2_30", "qual_dtype", "esc_neg"])
def test_emit_rejects_bad_arguments(bad):
    g = torch.zeros(8, dtype=torch.int32)
    args = dict(g_pos=g, bin_counts=torch.zeros(3, dtype=torch.int32),
                qual=torch.zeros(8, dtype=torch.uint8), nbins=2, esc_cap=0,
                out_size=64)
    args.update({
        "gpos_dtype": dict(g_pos=g.long()),
        "gpos_empty": dict(g_pos=g[:0]),
        "nbins125": dict(nbins=125,
                         bin_counts=torch.zeros(126, dtype=torch.int32),
                         out_size=1024),
        "counts_shape": dict(bin_counts=torch.zeros(2, dtype=torch.int32)),
        "out_below_table": dict(out_size=7),
        "out_2_30": dict(out_size=1 << 30),
        "qual_dtype": dict(qual=torch.zeros(8, dtype=torch.int32)),
        "esc_neg": dict(esc_cap=-1),
    }[bad])
    with pytest.raises(ValueError):
        TK.qualcol_emit(**args)
    if bad in ("gpos_dtype", "gpos_empty", "out_2_30"):
        with pytest.raises(ValueError):
            TK.positions_emit(args["g_pos"], 100, args["out_size"])


# ---------------------------------------------------------------------------
# A numpy model of csrc/emit.cu's tile decomposition, held byte for byte
# against chip_smoke.emit_ref: the operator (brk, lead, mid, trail) and the
# prefix state (u, r), tiles of T grouped elements (16 a thread, warps of
# 32 threads) that publish their own values, found within the tile from
# two integer scans (the last break before each thread, the bytes of the
# runs that start in the tile), each thread's bytes from the tile's first
# break on with its carried run and first offset (none of them hangs on the
# tiles before), a look-back from any earlier inclusive record (the nearest
# one the kernel found) folding the values after it a window at a time,
# then the lead run's tokens in front,
# fill tiles that leave, the length table from the tiles' local offsets and
# the zeros past the total, over a buffer that starts as 0xFF garbage with
# only the status words and the table cleared.
# ---------------------------------------------------------------------------

from functools import reduce

from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

NONE, GAP1, GAP2, GAP4, ADJ, ESC = range(6)
NBYTES = (0, 1, 2, 4, 0, 5)
M32 = 0xFFFFFFFF
IDENT = (False, 0, 0, 0)


def _ceil32(x):
    return (x + 31) >> 5


def _combine(a, b):
    """First a, then b: values (brk, lead, mid, trail), mid mod 2^32."""
    ab, al, am, at = a
    bb, bl, bm, bt = b
    if not bb:
        if not ab:
            return (False, al + bl, 0, al + bl)
        return (True, al, am, at + bl)
    if not ab:
        return (True, al + bl, bm, bt)
    return (True, al, (am + _ceil32(at + bl) + bm) & M32, bt)


def _elem(kind):
    return (False, 1, 0, 1) if kind == ADJ else (True, 0, NBYTES[kind], 0)


def _fold(vals):
    return reduce(_combine, vals, IDENT)


def _apply(s, v):
    """The prefix state (u, r) after a stretch of value v."""
    u, r = s
    u = u + _ceil32(r + v[1]) - (r != 0)
    if v[0]:
        return ((u + v[2] + _ceil32(v[3])) & M32, v[3] & 31)
    return (u & M32, (r + v[1]) & 31)


def _kinds(entry, args):
    """Each grouped element's kind and delta, as the kernel classifies
    them, and the call's layout."""
    a = [x.cpu().numpy() if hasattr(x, "cpu") else x for x in args]
    table = entry == "qualcol_emit"
    if table:
        g, counts, qual, nbins, esc_cap, out_size = a
        starts = np.concatenate([[0], np.cumsum(counts.astype(np.int64))])
        limit = 1 << 40
    else:
        g, limit, out_size = a
        nbins, esc_cap, qual, starts = 0, 0, None, None
    g = g.astype(np.int64)
    m = g.shape[0]
    stream_end = min(int(starts[nbins]), m) if table else m
    esc_end = min(int(starts[nbins + 1]), m) if table else m
    i = np.arange(m)
    seg = i == 0
    if table:
        b = starts[1:nbins + 1]
        seg[b[b < m]] = True
    prev = np.concatenate([[0], g[:-1]])
    d = np.where(seg, g + 1, g - prev)
    d = (d + 2**31) % 2**32 - 2**31
    stream = (i < stream_end) & (g < limit)
    adj = stream & (d == 1) & (g > 1)
    gap = stream & ~adj
    kinds = np.full(m, NONE)
    kinds[gap & (d <= 128)] = GAP1
    kinds[gap & (d > 128) & (d <= 1 << 14)] = GAP2
    kinds[gap & (d > 1 << 14)] = GAP4
    kinds[adj] = ADJ
    kinds[(i >= stream_end) & (i < esc_end)] = ESC
    return dict(table=table, g=g, m=m, d=d, kinds=kinds, starts=starts,
                nbins=nbins, esc_cap=esc_cap, qual=qual, limit=limit,
                out_size=out_size, stream_end=stream_end, esc_end=esc_end,
                hdr=4 * nbins)


def _bytes_of(c, i, u, r):
    """(the bytes element i emits in state (u, r), the next r)."""
    kind, m, kinds = c["kinds"][i], c["m"], c["kinds"]
    v = (int(c["d"][i]) - 1) & M32
    if kind == ADJ:
        out = []
        if r == 0:
            cov = 1
            while cov < 32 and i + cov < m and kinds[i + cov] == ADJ:
                cov += 1
            out = [(cov - 1) | 0xC0]
        return out, (r + 1) & 31
    if kind == GAP1:
        return [v & 0xFF], 0
    if kind == GAP2:
        return [((v >> 8) | 0x80) & 0xFF, v & 0xFF], 0
    if kind == GAP4:
        return [((v >> 24) | 0xE0) & 0xFF, (v >> 16) & 0xFF, (v >> 8) & 0xFF,
                v & 0xFF], 0
    if kind == ESC:
        p = int(c["g"][i])
        ek = i - c["stream_end"]
        pos = p & M32 if c["esc_cap"] > 0 else 0
        q = c["qual"]
        ch = (int(q[min(max(p, 0), q.shape[0] - 1)])
              if c["esc_cap"] > 0 and ek < c["esc_cap"] else 0)
        return [ch] + list(pos.to_bytes(4, "little")), 0
    return [], 0


def model_emit(entry, args, tile, per=16, seed=0):
    """(out, total) of a call as csrc/emit.cu computes it at tiles of
    `tile` grouped elements, per a thread, warps of 32 threads."""
    c = _kinds(entry, args)
    m, kinds, hdr, out_size = c["m"], c["kinds"], c["hdr"], c["out_size"]
    rng = np.random.default_rng(seed)
    threads = tile // per
    tiles = -(-m // tile)
    if c["table"]:
        kept_tiles = -(-c["esc_end"] // tile)
    else:
        fill = np.flatnonzero(c["g"][::tile] >= c["limit"])
        kept_tiles = int(fill[0]) if fill.shape[0] else tiles
    # the tiles that leave at once hold nothing to emit
    assert not kinds[kept_tiles * tile:].any()
    buf = np.full(out_size, 0xFF, np.uint8)
    written = np.zeros(out_size, np.int64)
    buf[:hdr] = 0  # the memset: status words and the length table
    written[:hdr] = 1
    lens = np.zeros(c["nbins"], np.int64)
    aggs, incls, total = [], [], None
    for j in range(kept_tiles):
        s = j * tile
        ks = [int(kinds[s + e]) if s + e < m else NONE for e in range(tile)]
        brk = [e for e in range(tile) if ks[e] != ADJ]
        # within the tile: the last break before each thread, the tile's
        # first and last, each thread's bytes from the runs that start in
        # the tile (those before its first break wait for the carried run)
        na_before = [max([e for e in brk if e < t * per], default=-1)
                     for t in range(threads)]
        tbytes = []
        for t in range(threads):
            at, b = na_before[t], 0
            for e in range(t * per, (t + 1) * per):
                if ks[e] == ADJ:
                    b += at >= 0 and (e - at - 1) % 32 == 0
                else:
                    b += NBYTES[ks[e]]
                    at = e
            tbytes.append(b)
        if brk:
            trail = tile - 1 - brk[-1]
            agg = (True, brk[0], (sum(tbytes) - _ceil32(trail)) & M32, trail)
        else:
            agg = (False, tile, 0, tile)
        assert agg == _fold(_elem(k) for k in ks)
        aggs.append(agg)
        if j == 0:
            pre = (0, 0)
        else:
            # the nearest inclusive record the look-back finds: any earlier
            # tile's, or the start; the values after it a window at a time
            k = int(rng.integers(-1, j))
            window = int(rng.choice([1, 3, 32, 512]))
            acc, hi = IDENT, j - 1
            while hi > k:
                lo = max(k + 1, hi - window + 1)
                acc = _combine(_fold(aggs[lo:hi + 1]), acc)
                hi = lo - 1
            pre = _apply((0, 0) if k < 0 else incls[k], acc)
            assert pre == incls[j - 1]
        after = _apply(pre, agg)
        incls.append(after)
        # each thread's bytes from the tile's first break on (from its own
        # first break in the tile's lead), at offsets past the lead's
        rest = {}
        local = np.zeros(tile + 1, np.int64)
        first = brk[0] if brk else tile
        for t in range(threads):
            e0 = t * per
            o = sum(tbytes[:t])
            r = (e0 - na_before[t] - 1) & 31 if na_before[t] >= 0 else 0
            for e in range(max(e0, first), e0 + per):
                local[e] = o
                if s + e >= m:
                    r = 0
                    continue
                out, r = _bytes_of(c, s + e, o, r)
                for x, byte in enumerate(out):
                    assert o + x not in rest
                    rest[o + x] = byte
                o += len(out)
        local[tile] = sum(tbytes)
        assert sorted(rest) == list(range(sum(tbytes)))
        # the lead's run tokens, once the carried run's phase is known
        pr = pre[1]
        nlead = _ceil32(pr + first) - (pr != 0)
        lead = {}
        for e in range(first):
            if (pr + e) % 32 == 0:
                out, _ = _bytes_of(c, s + e, 0, 0)
                lead[_ceil32(pr + e) - (pr != 0)] = out[0]
        assert sorted(lead) == list(range(nlead))
        assert nlead + sum(tbytes) == (after[0] - pre[0]) & M32 <= 5 * tile
        tile_bytes = [lead[x] for x in range(nlead)] + [rest[x] for x in
                                                        range(sum(tbytes))]
        for x, byte in enumerate(tile_bytes):
            at = hdr + pre[0] + x
            if at < out_size:
                buf[at] = byte
                written[at] += 1
        if c["table"]:
            # a bin's edges are breaks (or the tile's start): past the lead
            st_ = c["starts"]
            hi_end = min(s + tile, m)
            for b in range(c["nbins"]):
                lo = min(max(int(st_[b]), s), hi_end)
                hi = min(max(int(st_[b + 1]), s), hi_end)
                lens[b] += ((0 if hi == s else nlead + local[hi - s])
                            - (0 if lo == s else nlead + local[lo - s]))
        last = (s + tile >= c["esc_end"] if c["table"] else
                s + tile >= m or c["g"][s + tile] >= c["limit"])
        if last:
            assert total is None
            total = hdr + after[0]
    if kept_tiles == 0:
        total = hdr  # tile 0's block
    assert total is not None
    for b in range(c["nbins"]):
        buf[4 * b:4 * b + 4] = np.frombuffer(
            int(lens[b] & M32).to_bytes(4, "little"), np.uint8)
    # the zeros past the total, by the blocks whose tickets ran out
    buf[total:] = 0
    written[total:] += 1
    assert (written == 1).all()
    return buf, (total + 2**31) % 2**32 - 2**31


# (the tile a case is placed by, the model's tile, its elements a thread):
# the kernel's quality tiles and N-stream tiles, and small tiles that runs
# cross many times
_MODEL_TILES = [(4096, 4096, 16), (1024, 1024, 4), (4096, 96, 16),
                (256, 256, 16), (1024, 64, 4)]


@pytest.mark.parametrize("tiles", _MODEL_TILES,
                         ids=["%d-at-%d-by-%d" % t for t in _MODEL_TILES])
@pytest.mark.parametrize("name", EMIT_CASES + POS_CASES)
def test_tile_model_matches_the_numpy_loop(name, tiles):
    """Each case, placed by tiles of case_tile elements, through the model
    at tiles of model_tile, per elements a thread: the whole buffer and
    the total equal to chip_smoke.emit_ref's."""
    case_tile, model_tile, per = tiles
    entry, args = emit_args(name, case_tile)
    out, total = model_emit(entry, args, model_tile, per, seed=len(name))
    rout, rtotal = emit_ref(entry, args)
    assert total == rtotal
    assert np.array_equal(out, rout)


_kind_lists = st.lists(st.sampled_from([NONE, GAP1, GAP2, GAP4, ESC, ADJ,
                                        ADJ, ADJ, ADJ]), max_size=120)


def _val_of(ks):
    return _fold(_elem(k) for k in ks)


@settings(max_examples=300, deadline=None)
@given(_kind_lists, _kind_lists, _kind_lists)
def test_operator_is_associative(a, b, c):
    """(A B) C = A (B C), and a state after A then B is the state after
    A B, for values of element streams of any kinds."""
    va, vb, vc = _val_of(a), _val_of(b), _val_of(c)
    assert _combine(_combine(va, vb), vc) == _combine(va, _combine(vb, vc))
    assert _combine(va, vb) == _val_of(a + b)
    for s in ((0, 0), (7, 0), (9, 5), (M32 - 2, 31)):
        assert _apply(_apply(s, va), vb) == _apply(s, _combine(va, vb))


@settings(max_examples=300, deadline=None)
@given(st.lists(st.sampled_from([GAP1, GAP2, GAP4, ESC, NONE, ADJ, ADJ,
                                 ADJ]), min_size=1, max_size=300),
       st.lists(st.integers(0, 300), max_size=8))
def test_any_split_folds_to_the_same_bytes_and_run(ks, cuts):
    """A stream (its first element not adjacent, as a segment's first
    never is) cut anywhere folds to the same value, and the state it
    leaves is its byte count and its carried run mod 32, as a walk element
    by element counts them."""
    ks = [GAP1] + ks
    bounds = sorted({0, len(ks), *(c % (len(ks) + 1) for c in cuts)})
    pieces = [ks[a:b] for a, b in zip(bounds, bounds[1:])]
    whole = _val_of(ks)
    assert _fold(_val_of(p) for p in pieces) == whole
    state = (0, 0)
    for p in pieces:
        state = _apply(state, _val_of(p))
    u = run = 0
    for k in ks:
        if k == ADJ:
            u += run % 32 == 0
            run += 1
        else:
            u += NBYTES[k]
            run = 0
    assert whole[0] and state == (u, run % 32) == _apply((0, 0), whole)


@st.composite
def _stream_calls(draw):
    """A model tile and its elements a thread, and a call of either entry:
    bins (or the N stream) of runs up to 200 long and gaps up to 2^20, some
    bins filled to a multiple of the tile (the next starts at an edge),
    escapes, fill past the kept elements, caps and an out_size that may cut
    the stream."""
    tile, per = draw(st.sampled_from([(32, 16), (64, 16), (96, 16), (32, 4),
                                      (64, 4)]))

    def positions(base):
        pos, at = [], base
        for kind, k in draw(st.lists(st.tuples(
                st.sampled_from(["run", "gap", "gaps"]),
                st.integers(1, 200)), max_size=6)):
            if kind == "run":
                at += draw(st.integers(1, 40))
                pos.extend(range(at, at + k))
                at += k - 1
            else:
                for _ in range(k if kind == "gaps" else 1):
                    at += draw(st.sampled_from([1, 2, 128, 129, 16384, 16385,
                                                1 << 20]))
                    pos.append(at)
        return pos

    fill = draw(st.integers(0, 4 * tile))
    if draw(st.booleans()):
        pos = positions(draw(st.integers(0, 3)))
        n = (pos[-1] + 1 if pos else 0) + draw(st.integers(1, 50))
        g = np.array(pos + [n] * fill or [n], np.int32)
        out_size = draw(st.sampled_from([4 * len(pos) + 16,
                                         draw(st.integers(0, 64))]))
        return tile, per, "positions_emit", [torch.from_numpy(g), n,
                                             out_size]
    nbins = draw(st.integers(1, 5))
    bins = []
    for _ in range(nbins):
        pos = positions(draw(st.integers(0, 3)))
        if pos and draw(st.booleans()):  # pad the bins so far to an edge
            have = sum(len(b) for b in bins) + len(pos)
            pos += list(range(pos[-1] + 3, pos[-1] + 3 + 2 * ((-have) % tile),
                              2))
        bins.append(pos)
    esc = draw(st.lists(st.integers(0, 5000), max_size=40))
    kept = [p for b in bins for p in b] + esc
    top = max(kept, default=0) + 1
    n = top + draw(st.integers(1, 50))
    g = np.array(kept + [n] * fill or [n], np.int32)
    counts = np.array([len(b) for b in bins] + [len(esc)], np.int32)
    qual = np.frombuffer(np.random.default_rng(top).bytes(n), np.uint8)
    esc_cap = draw(st.sampled_from([0, len(esc), max(0, len(esc) - 3),
                                    len(esc) + 5]))
    total_max = 4 * nbins + 5 * len(kept) + 16
    out_size = draw(st.sampled_from([total_max, 4 * nbins + draw(
        st.integers(0, 200))]))
    return tile, per, "qualcol_emit", [torch.from_numpy(g),
                                  torch.from_numpy(counts),
                                  torch.from_numpy(qual.copy()), nbins,
                                  esc_cap, out_size]


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.data_too_large])
@given(_stream_calls(), st.integers(0, 1000))
def test_tile_model_on_drawn_streams(call, seed):
    """Drawn streams of both entries (long runs across tiles, bins starting
    at tile edges, escapes and their caps, fill tiles, cut outputs) through
    the model at small tiles: buffer and total equal to
    chip_smoke.emit_ref's and to the wrapper's plain version."""
    tile, per, entry, args = call
    out, total = model_emit(entry, args, tile, per, seed=seed)
    rout, rtotal = emit_ref(entry, args)
    assert total == rtotal and np.array_equal(out, rout)
    pout, ptotal = getattr(TK, entry)(*args)
    assert int(ptotal) == total and np.array_equal(pout.numpy(), out)


def test_emit_source_reads_its_records_relaxed_in_one_look_back():
    """csrc/emit.cu reads its tile records with relaxed loads (each record
    validates itself), never an acquire load, and each tile takes one
    look-back: one call of look_back in the kernel."""
    import os

    import repaq_tpu_torch

    src = os.path.join(os.path.dirname(repaq_tpu_torch.__file__), "csrc",
                       "emit.cu")
    with open(src) as f:
        text = f.read()
    assert "ld.acquire" not in text and "ld.relaxed.gpu" in text
    kernel = text[text.index("emit_kernel(Params p) {"):]
    assert kernel.count("look_back<") == 1
