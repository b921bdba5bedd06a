"""The decode's gap/run token parse (kernels.qualcol_parse and
kernels.positions_parse; csrc/parse.cu on a card, their plain torch
versions here) and its callers (qualcol_decode_device,
DeviceEngine._decode_step) against the JAX package's stream decoders
(repaq_tpu/ops/device_streams.py: qualcol_decode_device,
decode_positions_device), the host decoders (repaq_tpu_torch.codec.
kernels_np: decode_qual_by_col, decode_positions), chip_smoke.parse_ref (a
numpy loop over the grammar) and a Python model of csrc/parse.cu's tiles
and look-back. The cases are chip_smoke's PARSE_CASES and PARSE_POS_CASES,
placed at the kernel's tile of 4,096 stream bytes: tokens across tile
edges, bin streams starting at them, 4-byte gaps up to 2^29 and advances
past 2^31, runs of 32, 33 and 64 positions, empty bins, a table alone,
tok_cap below the tokens, escapes and none, FSM entry states that never
meet, 124 bins, and corrupt tables (stream starts out of order, streams
past qual_len, an end before the table, a window past the buffer's end).
Everything is integer: the tolerance is exact equality."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repaq_tpu.ops import device_streams as D
from repaq_tpu_torch.codec import kernels_np as K
from repaq_tpu_torch.codec import vectorized
from repaq_tpu_torch.codec.device_engine import DeviceEngine
from repaq_tpu_torch.ops import device_streams as T
from repaq_tpu_torch.ops import kernels as TK

from chip_smoke import (PARSE_CASES, PARSE_POS_CASES, _upper_bound, _wrap32,
                        parse_args, parse_moved, parse_pos_case,
                        parse_quality_case, parse_ref)
from test_device_engine import _mk_block
from test_torch_reference import jax_native  # noqa: F401

# repaq_tpu's native code runs from its source built for this CPU
pytestmark = pytest.mark.usefixtures("jax_native")

TILE = 4096  # csrc/parse.cu's kTile (kernels.parse_tile() on a card)
# the valid streams (the encoder's grammar, positions below 2^24) a
# decode can be held to JAX's and the host's on; the host decodes every
# token, so cases whose caps cut the stream are held to JAX's alone
DECODE_CASES = ("single", "runs", "bin_edges", "empty_bins", "table_only",
                "escapes", "esc_cap_above", "no_merge")
CUT_CASES = ("tok_cap_cut", "tok_cap_1")
POS_HOST_CASES = ("pos_single", "pos_edges", "pos_no_merge", "pos_empty",
                  "pos_cap_cut")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _outputs(got):
    return [g.numpy() for g in got]


@pytest.mark.parametrize("name", PARSE_CASES + PARSE_POS_CASES)
def test_parse_plain_matches_the_numpy_loop(name):
    """Each case at the kernel's interface: the wrapper on CPU tensors (its
    plain version) equal to chip_smoke.parse_ref, output by output, and no
    launch counted."""
    entry, args = parse_args(name, TILE)
    before = dict(TK.launches)
    got = getattr(TK, entry)(*args)
    assert TK.launches == before
    ref = parse_ref(entry, args)
    assert len(got) == len(ref) == (5 if entry == "qualcol_parse" else 2)
    for g, r in zip(got, ref):
        assert g.dtype == torch.from_numpy(r).dtype
        assert np.array_equal(g.numpy(), r)


def _random_stream(rng, kind):
    """A small random quality buffer (table, streams of random bytes,
    escape bytes) or N-position buffer: the grammar's every token form, in
    valid and corrupt tables alike."""
    m = int(rng.integers(5, 400))
    buf = rng.integers(0, 256, m, dtype=np.uint8)
    if kind == "positions":
        return [_t(buf), int(rng.integers(0, m + 3)),
                int(rng.integers(1, m + 8))]
    nbins = int(rng.integers(0, min(8, m // 4) + 1))
    room = m - 4 * nbins
    lens = rng.integers(0, max(1, room // max(nbins, 1)) + 3, nbins)
    if nbins and rng.random() < 0.3:   # out of order or past the buffer
        lens[rng.integers(0, nbins)] = rng.choice(
            [0xFFFFFFF0, 0x80000001, room + 9])
    buf[:4 * nbins] = np.asarray(lens, "<u4").view(np.uint8)
    return [_t(buf), int(rng.integers(4 * nbins, m + 30)), nbins,
            int(rng.integers(1, m + 5)), int(rng.integers(0, 12))]


@pytest.mark.parametrize("seed", range(24))
@pytest.mark.parametrize("kind", ["quality", "positions"])
def test_parse_plain_matches_the_numpy_loop_on_random_bytes(kind, seed):
    """Random bytes under random tables (sorted, out of order, past the
    buffer, empty), valid lengths and caps: the plain version equal to
    parse_ref and to the kernel's model at tiles of 64 and 4,096 bytes.
    A draw the plain version refuses (an escape record indexed below the
    buffer's start, which torch's indexing raises on) is not an input it
    takes, and is drawn again."""
    rng = np.random.default_rng(seed + (1000 if kind == "positions" else 0))
    entry = "qualcol_parse" if kind == "quality" else "positions_parse"
    taken = 0
    while taken < 6:
        args = _random_stream(rng, kind)
        try:
            got = _outputs(getattr(TK, entry)(*args))
        except IndexError:
            continue
        taken += 1
        for r in parse_ref(entry, args):
            assert np.array_equal(got.pop(0), r)
        for threads in (4, 256):
            model = _kernel_model(entry, args, threads=threads, seed=seed)
            for g, r in zip(getattr(TK, entry)(*args), model):
                assert np.array_equal(g.numpy(), r)


@pytest.mark.parametrize("name", PARSE_CASES + PARSE_POS_CASES)
def test_parse_ref_routes_agree(name):
    """parse_ref's numpy route (the host coder's walk a bin, an int64 sum),
    which it takes at real chunk sizes, equal to its byte loop wherever it
    applies (a valid table, sums below 2^31)."""
    entry, args = parse_args(name, TILE)
    loop = parse_ref(entry, args, fast=False)
    for g, r in zip(parse_ref(entry, args, fast=True), loop):
        assert np.array_equal(g, r)


@pytest.mark.parametrize("name", PARSE_CASES + PARSE_POS_CASES)
def test_kernel_model_matches_plain(name):
    """csrc/parse.cu's algorithm, modelled in Python (the four entry
    states' walks and sums, the block's map and channel scans, the
    look-back from the nearest inclusive record among the 32 tiles before
    (at a random depth) through each newer tile's sums in its entry state,
    the running max's look-back, the bins' first tokens and the escape
    records), at 16-byte threads and tiles of 4 and 256 threads: equal to
    the plain version on every case."""
    entry, args = parse_args(name, TILE)
    want = _outputs(getattr(TK, entry)(*args))
    for threads in (4, 256):
        got = _kernel_model(entry, args, threads=threads, seed=len(name))
        for g, w in zip(got, want):
            assert np.array_equal(g, w)


# ---------------------------------------------------------------------------
# a Python model of csrc/parse.cu
# ---------------------------------------------------------------------------

_PER = 16


def _ch(c=0, a=0, off=0, has=False, pend=False):
    return (c, a, off, has, pend)


def _combine(A, B):
    """first A, then B (parse.cu's combine)."""
    first = A[4] and B[0] > 0
    return (A[0] + B[0], A[1] + B[1],
            A[1] + B[2] if B[3] else (A[1] if first else A[2]),
            A[3] or B[3] or first,
            B[4] if B[0] > 0 else (A[4] or B[4]))


_VALID = 1 << 63
_LOW42 = (1 << 42) - 1
_IDENTITY = 0x03020100


def _agg_words(amap, ach):
    """A tile's function as publish_agg writes it: two words a state."""
    words = []
    for e in range(4):
        c, a, off, has, pend = ach[e]
        words += [_VALID | amap[e] << 61 | int(pend) << 60 | int(has) << 59
                  | c << 42 | (a & _LOW42), _VALID | off]
    return words


def _incl_words(x, ch):
    c, a, off, _has, pend = ch
    return [_VALID | x << 61 | int(pend) << 60 | c, _VALID | a, _VALID | off]


def _compose_map(a, b):
    """compose_map: byte s of the result is byte a[s] of b (32-bit maps)."""
    return sum(((b >> (8 * ((a >> (8 * s)) & 3))) & 0xFF) << (8 * s)
               for s in range(4))


def _apply(m, s):
    return (m >> (8 * s)) & 3


def _warp_lookback(lanes, init):
    """(x, prefix) as warp 0 of csrc/parse.cu resolves them: lanes[l] is
    None before the first tile, else (function words, inclusive words or
    None) of tile j - 1 - l, decoded, composed and folded lane by lane in
    the kernel's Hillis-Steele steps."""
    incl = [ln is None or ln[1] is not None for ln in lanes]
    nearest = incl.index(True)
    maps, vals = [], []
    for l, ln in enumerate(lanes):
        m, v = _IDENTITY, _ch()
        if l == nearest:
            x = 0
            if ln is not None:
                w = ln[1]
                x = (w[0] >> 61) & 3
                v = (w[0] & 0xFFFFFFFF, w[1] & ~_VALID, w[2] & ~_VALID, True,
                     bool((w[0] >> 60) & 1))
            else:
                v = init
            m = x * 0x01010101
        elif l < nearest:
            m = 0
            for e in range(4):
                m |= ((ln[0][2 * e] >> 61) & 3) << (8 * e)
        maps.append(m)
        vals.append(v)
    d = 1
    while d < 32:
        maps = [_compose_map(maps[l + d], maps[l]) if l + d < 32 else maps[l]
                for l in range(32)]
        d *= 2
    for l in range(nearest):
        w = lanes[l][0]
        e = _apply(maps[l + 1], 0)
        a = w[2 * e]
        vals[l] = ((a >> 42) & 0x1FFFF, a & _LOW42, w[2 * e + 1] & ~_VALID,
                   bool((a >> 59) & 1), bool((a >> 60) & 1))
    d = 1
    while d < 32:
        vals = [_combine(vals[l + d], vals[l]) if l + d < 32 else vals[l]
                for l in range(32)]
        d *= 2
    return _apply(maps[0], 0), vals[0]


def _token(win):
    b0, b1, b2, b3 = win
    npos = (b0 & 0x1F) + 1 if 0xC0 <= b0 < 0xE0 else 1
    dist = (b0 + 1 if b0 < 0x80 else
            (((b0 & 0x3F) << 8) | b1) + 1 if b0 < 0xC0 else
            (((b0 & 0x1F) << 24) | (b1 << 16) | (b2 << 8) | b3) + 1
            if b0 >= 0xE0 else 1)
    return dist, npos


def _kernel_model(entry, args, threads, seed=0):
    """The outputs of csrc/parse.cu's kernel on args, its tiles of
    `threads` threads of 16 bytes run in ticket order with every
    look-back's depth drawn at random."""
    rng = random.Random(seed)
    buf = [int(x) for x in args[0].numpy()]
    m = len(buf)
    table = entry == "qualcol_parse"
    if table:
        _b, limit, nb, tok_cap, esc_cap = args
    else:
        _b, limit, tok_cap = args
        nb, esc_cap = 0, 0
    lens = [_wrap32(int.from_bytes(bytes(buf[4 * b:4 * b + 4]), "little"))
            for b in range(nb)]
    sb, at = [], 0
    for v in lens:
        sb.append(_wrap32(4 * nb + at))
        at = _wrap32(at + v)
    if table:
        end = _wrap32(4 * nb + at)
        lo = 4 * nb
        hi = min(max(end, lo), m)
    else:
        end, lo, hi = 0, 0, min(max(limit, 0), m)
    base = lo & ~15
    fpos = [min(max(s, 0), m) for s in sb]
    bnd = {}
    srt = all(sb[b - 1] <= sb[b] for b in range(1, nb))
    for s in range(1, nb):
        if srt:
            bnd[s] = min(max(sb[s], 0), m)
        else:
            l, h = 0, m
            while l < h:
                mid = (l + h) >> 1
                if _upper_bound(sb, mid) >= s + 1:
                    h = mid
                else:
                    l = mid + 1
            bnd[s] = l
    T = threads * _PER
    tiles = (hi - base + T - 1) // T if hi > base else 1
    byte = lambda i: buf[i % m] if i < m + 3 else 0  # noqa: E731
    start = np.zeros(tok_cap, np.int32)
    count = np.zeros(tok_cap, np.int32)
    seg_off = np.zeros(nb + 1 if table else 0, np.int32)
    # per tile: its function, its inclusive values, and its max word
    # (inclusive, and the aggregate a slow tile publishes first)
    aggs, incls, maxw = [], [], []
    init = _ch(has=True)
    for j in range(tiles):
        t0 = base + j * T
        fb = {q - t0 for q in fpos if 0 <= q - t0 < T}
        bb = {bnd[s] - t0 for s in bnd if 0 <= bnd[s] - t0 < T}
        own, maps, masks = [], [], []
        for t in range(threads):
            S = [0, 1, 2, 3]
            sm = [set(), set(), set(), set()]
            for k in range(_PER):
                q = _PER * t + k
                i = t0 + q
                ins = lo <= i < hi
                b0 = byte(i)
                len1 = (0 if b0 < 0x80 else 1 if b0 < 0xC0 else 0
                        if b0 < 0xE0 else 3) if ins else 0
                forced = ins and q in fb
                z = [forced or S[u] == 0 for u in range(4)]
                for u in range(4):
                    if ins and z[u]:
                        sm[u].add(k)
                S = [len1 if z[u] else S[u] - 1 for u in range(4)]
            sums = []
            for u in range(4):
                c, a, off, has, pend = _ch()
                for k in range(_PER):
                    if _PER * t + k in bb:
                        pend = True
                    if k in sm[u]:
                        if pend:
                            has, off, pend = True, a, False
                        d, n = _token([byte(t0 + _PER * t + k + x)
                                       for x in range(4)])
                        a += d + n - 1
                        c += 1
                sums.append((c, a, off, has, pend))
            own.append(sums)
            maps.append(S)
            masks.append(sm)
        # the block's scans: thread t's entry state and sums before it, per
        # tile entry state
        pmap, ex = [], []
        acc_map, acc = [0, 1, 2, 3], [_ch()] * 4
        for t in range(threads):
            pmap.append(acc_map)
            ex.append(acc)
            acc = [_combine(acc[e], own[t][acc_map[e]]) for e in range(4)]
            acc_map = [maps[t][acc_map[e]] for e in range(4)]
        tile_fn = (acc_map, acc)
        aggs.append(tile_fn)
        # the look-back: the nearest inclusive record among the 32 tiles
        # before (at a random depth), each newer tile's sums in its entry
        # state folded in order
        depth = rng.randint(1, min(32, j + 1))
        lanes = []
        for l in range(32):
            i = j - 1 - l
            if i < 0:
                lanes.append(None)
            else:
                shown = l == depth - 1 or (l >= depth and rng.random() < 0.5)
                lanes.append((_agg_words(*aggs[i]),
                              _incl_words(*incls[i]) if shown else None))
        x, pre = (0, init) if j == 0 else _warp_lookback(lanes, init)
        tile_end = _combine(pre, acc[x])
        incls.append((acc_map[x], tile_end))
        slow = table and tile_end[1] >= 1 << 31
        tok_base, tok_mask, tmaxes, curs = [], [], [], []
        for t in range(threads):
            u = pmap[t][x]
            cur = _combine(pre, ex[t][x])
            curs.append((u, cur))
            tok_base.append(cur[0])
            tok_mask.append(masks[t][u])
            if slow:
                c, a, off, has, pend = cur
                tm = None
                for k in range(_PER):
                    if _PER * t + k in bb:
                        pend = True
                    if k in masks[t][u]:
                        if pend:
                            w = _wrap32(a)
                            tm = w if tm is None else max(tm, w)
                            pend = False
                        d, n = _token([byte(t0 + _PER * t + k + q)
                                       for q in range(4)])
                        a += d + n - 1
                tmaxes.append(tm)
        if slow:
            tot = max([v for v in tmaxes if v is not None], default=-2**31)
            # the running max before the tile: back to an inclusive word
            mp = -2**31
            for i in range(j - 1, -2, -1):
                if i < 0:
                    mp = max(mp, 0)
                    break
                incl, agg = maxw[i]
                if agg is None or rng.random() < 0.5:
                    mp = max(mp, incl)
                    break
                mp = max(mp, agg)
            maxw.append((max(mp, tot), tot))
            run = mp
        elif table:
            maxw.append((_wrap32(tile_end[2]), None))
        for t in range(threads):
            u, cur = curs[t]
            c, a, off, has, pend = cur
            if slow:
                run = max([mp] + [v for v in tmaxes[:t] if v is not None])
            for k in range(_PER):
                if _PER * t + k in bb:
                    pend = True
                if k in masks[t][u]:
                    if pend:
                        off, pend = a, False
                        if slow:
                            run = max(run, _wrap32(a))
                    d, n = _token([byte(t0 + _PER * t + k + q)
                                   for q in range(4)])
                    b = max(run, 0) if slow else off
                    if c < tok_cap:
                        start[c] = _wrap32(a + d - 1 - b)
                        count[c] = n
                    a += d + n - 1
                    c += 1
        for s in range(1, nb):
            q = bnd[s] - t0
            tok = None
            if 0 <= q < T:
                t, bit = divmod(q, _PER)
                tok = tok_base[t] + sum(1 for k in tok_mask[t] if k < bit)
            elif q >= T and j == tiles - 1:
                tok = tile_end[0]
            if tok is not None:
                seg_off[s] = min(tok, tok_cap)
        if table and nb > 0 and j == tiles - 1:
            seg_off[nb] = min(tile_end[0], tok_cap)
    if not table:
        return start, count
    esc_pos = np.zeros(esc_cap, np.int32)
    esc_char = np.zeros(esc_cap, np.uint8)
    for e in range(esc_cap):
        rec = _wrap32(end + 5 * e)
        pos, ch = -1, 0
        if _wrap32(rec + 4) < limit:
            r = min(rec, m - 5)
            w = r + m + 3 if r < 0 else r
            r4 = min(r + 4, m - 1)
            r4 = r4 + m if r4 < 0 else r4
            we = 0
            if 0 <= w < m:
                we = sum(byte(w + k) << (8 * k) for k in range(4))
            top = buf[r4] if 0 <= r4 < m else 0
            ch = we & 0xFF
            pos = _wrap32(((we >> 8) & 0xFFFFFF) | top << 24)
        esc_pos[e], esc_char[e] = pos, ch
    return start, count, seg_off, esc_pos, esc_char


# ---------------------------------------------------------------------------
# the callers against the JAX package and the host decoders
# ---------------------------------------------------------------------------


def _quality_inputs(name):
    c = parse_quality_case(name, TILE)
    buf, nbins = c["buf"], c["nbins"]
    enc = buf[:c["qual_len"]]
    got = parse_ref("qualcol_parse", [buf, c["qual_len"], nbins, buf.shape[0],
                                      0])
    top = max([int(s + n) for s, n in zip(*got[:2]) if n] + [1])
    recs = enc[4 * nbins + int(np.asarray(enc[:4 * nbins]).view("<u4")
                                  .astype(np.int64).sum()):]
    recs = recs[:recs.shape[0] // 5 * 5].reshape(-1, 5)
    esc = recs[:, 1:].copy().view("<u4")[:, 0] if recs.shape[0] else []
    length = max([top] + [int(p) + 1 for p in esc])
    bins = np.arange(40, 40 + nbins, dtype=np.uint8)
    return c, enc, bins, length


@pytest.mark.parametrize("name", DECODE_CASES + CUT_CASES)
def test_qualcol_decode_matches_jax_and_host(name):
    """qualcol_decode_device (qualcol_parse, fill_sorted_runs, the
    escapes' fill_runs) on each valid case against JAX's with the same
    caps (both of its branches) and, where the caps hold every token, the
    host decoder."""
    c, enc, bins, length = _quality_inputs(name)
    nbins, major = c["nbins"], ord("F")
    t, pos_c, esc = K.qualcol_decode_counts(enc, nbins)
    caps = dict(tok_cap=c["tok_cap"] if name in CUT_CASES else t + 16,
                pos_cap=pos_c + 16, esc_cap=c["esc_cap"])
    got = T.qualcol_decode_device(_t(c["buf"]), nbins, _t(bins), major,
                                  length, c["qual_len"], **caps).numpy()
    if name not in CUT_CASES:
        assert c["esc_cap"] >= esc
        want = K.decode_qual_by_col(enc, bins, major, length)
        assert np.array_equal(got, want)
    for run_cap in (None, t + 16):
        jgot = jax.jit(lambda b, bn, ln: D.qualcol_decode_device(
            b, nbins, bn, jnp.uint8(major), length, ln, run_cap=run_cap,
            **caps))(jnp.asarray(c["buf"]), jnp.asarray(bins),
                     jnp.int32(c["qual_len"]))
        assert np.array_equal(got, np.asarray(jgot))


def test_qualcol_decode_124_bins_matches_host():
    """124 bins (past JAX's 63): the host decoder's bytes."""
    c, enc, bins, length = _quality_inputs("bins124")
    got = T.qualcol_decode_device(_t(c["buf"]), 124, _t(bins), ord("F"),
                                  length, c["qual_len"], esc_cap=0)
    assert np.array_equal(got.numpy(),
                          K.decode_qual_by_col(enc, bins, ord("F"), length))


@pytest.mark.parametrize("name", PARSE_POS_CASES)
def test_positions_runs_match_decode_positions(name):
    """positions_parse's runs, expanded in numpy (int32 positions), equal
    decode_positions_device's positions, which equal JAX's and, on the
    valid streams, the host decoder's."""
    c = parse_pos_case(name, TILE)
    buf, valid = c["buf"], c["valid_len"]
    start, count = TK.positions_parse(_t(buf), valid, c["cap"])
    runs = [_wrap32(int(s) + j) for s, n in zip(start.numpy(), count.numpy())
            for j in range(int(n))]
    total = int(parse_ref("positions_parse", [buf, valid, m_cap(buf)])[1]
                .sum())
    cap = max(1, total)
    pos, cnt = T.decode_positions_device(_t(buf), valid, cap)
    assert int(cnt) == total
    if c["cap"] >= valid:
        assert runs == pos.numpy()[:total].tolist()
    else:
        assert runs == pos.numpy()[:len(runs)].tolist()
    wpos, wcnt = jax.jit(D.decode_positions_device, static_argnums=2)(
        jnp.asarray(buf), jnp.int32(valid), cap)
    assert int(wcnt) == total
    assert np.array_equal(pos.numpy(), np.asarray(wpos))
    if name in POS_HOST_CASES:
        assert pos.numpy()[:total].tolist() == K.decode_positions(
            buf[:valid]).tolist()


def m_cap(buf):
    return max(1, buf.shape[0])


@pytest.mark.parametrize("pe", [False, True])
def test_engine_decode_through_the_parse(pe, monkeypatch):
    """One seeded SE chunk (with Ns and escape records) and one PE chunk
    through DeviceEngine("cpu", min_bases=0): the decode gives the input
    back, each stream one call of its parse entry, and no
    decode_positions_device or token FSM call outside the parse's plain
    versions; the parse's outputs equal parse_ref."""
    calls = {"qualcol_parse": [], "positions_parse": []}
    for name in calls:
        def counted(*a, _name=name, _fn=getattr(TK, name)):
            calls[_name].append(a)
            return _fn(*a)
        monkeypatch.setattr(TK, name, counted)
    monkeypatch.setattr(T, "decode_positions_device", None)
    eng = DeviceEngine("cpu", min_bases=0)
    if pe:
        block = _mk_block(600, 96, seed=7, pe_overlap=0.5, nfrac=0.01)
        header = vectorized.make_header_pe(block)
    else:
        header = vectorized.make_header_se(_mk_block(400, 80, seed=5))
        block = _mk_block(400, 80, seed=6, esc=True, nfrac=0.01)
    got = eng.encode_chunk(header, block, pe)
    back = eng.decode_chunk(header, got)
    assert np.array_equal(back.seq_flat, block.seq_flat)
    assert np.array_equal(back.qual_flat, block.qual_flat)
    assert eng.stats["device_decodes"] == 1
    assert {k: len(v) for k, v in calls.items()} == {"qualcol_parse": 1,
                                                      "positions_parse": 1}
    for entry, (args,) in calls.items():
        for g, r in zip(getattr(TK, entry)(*args), parse_ref(entry, args)):
            assert np.array_equal(g.numpy(), r)


def test_parse_moved_counts_bytes():
    """parse_moved: the stream's known bytes read, 8 bytes a token slot,
    the offsets and 10 bytes an escape slot."""
    entry, args = parse_args("escapes", TILE)
    buf, qual_len, nbins, tok_cap, esc_cap = args
    assert parse_moved(entry, args) == (qual_len + 8 * tok_cap
                                        + 4 * (nbins + 1) + 10 * esc_cap)
    entry, args = parse_args("pos_short", TILE)
    assert parse_moved(entry, args) == args[1] + 8 * args[2]


@pytest.mark.parametrize("bad", ["dtype", "2d", "short", "nbins125",
                                 "table_past_buf", "tok_cap0", "esc_neg",
                                 "len_neg"])
def test_parse_rejects_bad_arguments(bad):
    buf = torch.zeros(64, dtype=torch.uint8)
    args = dict(buf=buf, qual_len=8, nbins=2, tok_cap=8, esc_cap=0)
    args.update({
        "dtype": dict(buf=buf.to(torch.int32)),
        "2d": dict(buf=buf.reshape(8, 8)),
        "short": dict(buf=buf[:4]),
        "nbins125": dict(nbins=125, buf=torch.zeros(1024, dtype=torch.uint8)),
        "table_past_buf": dict(nbins=17),
        "tok_cap0": dict(tok_cap=0),
        "esc_neg": dict(esc_cap=-1),
        "len_neg": dict(qual_len=-1),
    }[bad])
    with pytest.raises(ValueError):
        TK.qualcol_parse(**args)
    if bad in ("dtype", "2d", "short", "tok_cap0", "len_neg"):
        with pytest.raises(ValueError):
            TK.positions_parse(args["buf"], args["qual_len"], args["tok_cap"])
