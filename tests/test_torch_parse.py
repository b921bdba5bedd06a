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
                "escapes", "esc_cap_above", "no_merge", "chain_edges",
                "meet_late", "head_bins")
CUT_CASES = ("tok_cap_cut", "tok_cap_1")
POS_HOST_CASES = ("pos_single", "pos_edges", "pos_no_merge", "pos_empty",
                  "pos_cap_cut", "pos_meet_late")


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
    states' walks, the block's map scan, the head's four channels and the
    rest's one, the look-back from the nearest inclusive record among the
    256 tiles before (at a random depth) through each newer tile's sums in
    its entry state, the running max's look-back, the bins' first tokens,
    and what the blocks write once their tickets run out: the escape
    records and the token slots past the last token), at 16-byte threads
    and tiles of 4 and 256 threads, every output starting as garbage:
    equal to the plain version on every case."""
    entry, args = parse_args(name, TILE)
    want = _outputs(getattr(TK, entry)(*args))
    for threads in (4, 256):
        got = _kernel_model(entry, args, threads=threads, seed=len(name))
        for g, w in zip(got, want):
            assert np.array_equal(g, w)


@pytest.mark.parametrize("wave", [1, 2, 3])
@pytest.mark.parametrize("name", ["gap_edges", "no_merge", "head_bins",
                                  "past_qual_len", "pos_edges",
                                  "pos_meet_late"])
def test_kernel_model_persistent_wave(name, wave):
    """A persistent wave of 1, 2 or 3 blocks over more tiles (of 4 threads,
    64 bytes): each block draws several tickets, holding its tile and the
    next, in an order drawn at random; the outputs equal the plain
    version's, and every ticket below the tiles is drawn once."""
    entry, args = parse_args(name, TILE)
    want = _outputs(getattr(TK, entry)(*args))
    info = {}
    got = _kernel_model(entry, args, threads=4, seed=wave, wave=wave,
                        info=info)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    taken = info["taken"]
    assert len(taken) <= wave
    assert max(len(t) for t in taken) > 2   # a tile, more, the last draw
    tiles = len(info["heads"])
    drawn = sorted(t for ts in taken for t in ts)
    assert drawn == list(range(tiles + len(taken)))
    assert all(ts[-1] >= tiles and all(t < tiles for t in ts[:-1])
               for ts in taken)


@pytest.mark.parametrize("name, kinds", [
    ("no_merge", {"all"}), ("chain_edges", {"all", "one"}),
    ("meet_late", {"one", "warp", "block"}),
    ("head_bins", {"one", "warp", "block"}),
    ("pos_no_merge", {"all"}), ("pos_meet_late", {"one", "warp", "block"}),
    ("gap_edges", {"one"}), ("wave", {"one"})])
def test_kernel_model_heads(name, kinds):
    """The tiles of 256 threads each case puts in each of the design's
    paths, by its head (the threads whose entry state depends on the
    tile's): thread 0 alone ("one"), within warp 0 ("warp"), past it
    ("block"), or every thread, the walks never meeting ("all")."""
    entry, args = parse_args(name, TILE)
    if name == "wave":
        buf = args[0][:3 * TILE]   # a few tiles of it
        args = [buf, 3 * TILE - 64, 2, 3 * TILE, 0]
        args[0][:8] = torch.tensor([0, 16, 0, 0, 0, 16, 0, 0],
                                   dtype=torch.uint8)
    info = {}
    _kernel_model(entry, args, threads=256, info=info)
    got = {"one" if h == 1 else "warp" if h <= 32 else "all" if h == 256
           else "block" for h in info["heads"]}
    assert kinds <= got, (got, info["heads"])


# ---------------------------------------------------------------------------
# a Python model of csrc/parse.cu
# ---------------------------------------------------------------------------

_PER = 16
_WARP = 32
_WINDOW = 256   # the look-back's window in parse.cu: a tile a thread, kThreads
_GARBAGE = (0x5A5A5A5A, 0x6B6B6B6B, 0x7C7C7C7C, 0xEE)  # what torch.empty may hold


def _ch(c=0, a=0, off=0, has=False, pend=False):
    return (c, a, off, has, pend)


def _combine(A, B):
    """first A, then B (parse.cu's combine)."""
    first = A[4] and B[0] > 0
    return (A[0] + B[0], A[1] + B[1],
            A[1] + B[2] if B[3] else (A[1] if first else A[2]),
            A[3] or B[3] or first,
            B[4] if B[0] > 0 else (A[4] or B[4]))


def _fold(vals):
    acc = _ch()
    for v in vals:
        acc = _combine(acc, v)
    return acc


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


def _wide_lookback(lanes, init):
    """(x, prefix) as the block of csrc/parse.cu resolves them: lanes[i]
    is None before the first tile, else (function words, inclusive words
    or None) of tile j - 1 - i, for the window's tiles; decoded, composed
    within warps of 32 (the older lane first), through the older warps'
    compositions, and folded in the kernel's Hillis-Steele steps, then
    across the warps, the oldest first."""
    incl = [ln is None or ln[1] is not None for ln in lanes]
    nearest = incl.index(True)
    n = len(lanes)
    maps, vals = [_IDENTITY] * n, [_ch()] * n
    for i, ln in enumerate(lanes):
        if i == nearest:
            x = 0
            if ln is not None:
                w = ln[1]
                x = (w[0] >> 61) & 3
                vals[i] = (w[0] & 0xFFFFFFFF, w[1] & ~_VALID, w[2] & ~_VALID,
                           True, bool((w[0] >> 60) & 1))
            else:
                vals[i] = init
            maps[i] = x * 0x01010101
        elif i < nearest:
            maps[i] = sum(((ln[0][2 * e] >> 61) & 3) << (8 * e)
                          for e in range(4))
    warps = [list(range(w0, min(w0 + _WARP, n))) for w0 in range(0, n, _WARP)]

    def down_steps(xs, op):
        out = list(xs)
        for idx in warps:
            seg = [out[i] for i in idx]
            d = 1
            while d < _WARP:
                seg = [op(seg[l + d], seg[l]) if l + d < len(seg) else seg[l]
                       for l in range(len(seg))]
                d *= 2
            for i, v in zip(idx, seg):
                out[i] = v
        return out

    maps = down_steps(maps, _compose_map)
    older = []
    for w in range(len(warps)):
        acc = _IDENTITY
        for q in range(len(warps) - 1, w, -1):
            acc = _compose_map(acc, maps[warps[q][0]])
        older.append(acc)
    maps = [_compose_map(older[i // _WARP], maps[i]) for i in range(n)]
    for i in range(nearest):
        before = (older[i // _WARP] if i % _WARP == _WARP - 1 or i + 1 == n
                  else maps[i + 1])
        w = lanes[i][0]
        e = _apply(before, 0)
        a = w[2 * e]
        vals[i] = ((a >> 42) & 0x1FFFF, a & _LOW42, w[2 * e + 1] & ~_VALID,
                   bool((a >> 59) & 1), bool((a >> 60) & 1))
    vals = down_steps(vals, _combine)
    pre = _fold(vals[idx[0]] for idx in reversed(warps))
    return _apply(maps[0], 0), pre


def _token(win):
    b0, b1, b2, b3 = win
    npos = (b0 & 0x1F) + 1 if 0xC0 <= b0 < 0xE0 else 1
    dist = (b0 + 1 if b0 < 0x80 else
            (((b0 & 0x3F) << 8) | b1) + 1 if b0 < 0xC0 else
            (((b0 & 0x1F) << 24) | (b1 << 16) | (b2 << 8) | b3) + 1
            if b0 >= 0xE0 else 1)
    return dist, npos


def _one_byte(b0):
    return b0 < 0x80 or 0xC0 <= b0 < 0xE0


def _walk4(b, ins, fb, fast):
    """walk4: the four entry states' start masks over a thread's bytes b,
    its exit state a state, and each walk's advances in 32 bits: in a warp
    whose every byte is a 1-byte token inside the stream (fast), by the
    byte sums (walk u starts at byte min(u, the first forced restart)),
    else byte by byte."""
    adv = [sum(_token(b[k:k + 4])) - 1 for k in range(_PER)]
    if fast:
        f = min(fb, default=_PER)
        total = _PER + sum(x if x < 0x80 else x & 0x1F for x in b[:_PER])
        a = [total]
        for u in range(1, 4):
            a.append(a[-1] - (adv[u - 1] if u - 1 < f else 0))
        return ([0xFFFF & ~((1 << min(u, f)) - 1) for u in range(4)],
                [0] * 4, a)
    S = [0, 1, 2, 3]
    sm = [0, 0, 0, 0]
    for k in range(_PER):
        inside = k in ins
        b0 = b[k]
        len1 = (0 if b0 < 0x80 else 1 if b0 < 0xC0 else 0 if b0 < 0xE0
                else 3) if inside else 0
        forced = inside and k in fb
        z = [forced or S[u] == 0 for u in range(4)]
        for u in range(4):
            if inside and z[u]:
                sm[u] |= 1 << k
        S = [len1 if z[u] else S[u] - 1 for u in range(4)]
    a = [sum(adv[k] for k in range(_PER) if sm[u] >> k & 1) & 0xFFFFFFFF
         for u in range(4)]
    return sm, S, a


def _sum_of(adv, mask, bb):
    """sum_of: the sums of the tokens starting at mask's bytes."""
    if not bb:
        return (bin(mask).count("1"),
                sum(adv[k] for k in range(_PER) if mask >> k & 1),
                0, False, False)
    c, a, off, has, pend = _ch()
    for k in range(_PER):
        if k in bb:
            pend = True
        if mask >> k & 1:
            if pend:
                has, off, pend = True, a, False
            a += adv[k]
            c += 1
    return (c, a, off, has, pend)


def _excl(vals):
    out, acc = [], _ch()
    for v in vals:
        out.append(acc)
        acc = _combine(acc, v)
    return out, acc


def _kernel_model(entry, args, threads, seed=0, wave=None, info=None):
    """The outputs of csrc/parse.cu's kernel on args: tiles of `threads`
    threads of 16 bytes drawn in ticket order by a persistent wave of
    blocks (`wave` of them, capped by the tiles the caller knows of; each
    block holds its tile and the next ticket), every look-back's nearest
    inclusive record drawn at random in the window, and every output
    starting as garbage, as torch.empty may leave it. info, a dict if
    given, gets the tickets each block drew ("taken") and each tile's head
    (the threads whose entry state depends on the tile's, "heads")."""
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
        if lo > m:
            lo = hi = m
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
    # the persistent wave: the tiles of the bytes the caller knows of, at
    # most `wave` blocks; tickets in order, each to a block that is free
    first_byte = (4 * nb) & ~15
    known = min(limit, m) - first_byte
    grid = max(1, min((known + T - 1) // T if known > 0 else 1,
                      wave or 1 << 30))
    taken, alive = [[] for _ in range(grid)], list(range(grid))
    for t in range(tiles + grid):   # a block draws until it runs out
        blk = t if t < grid else rng.choice(alive)
        taken[blk].append(t)
        if t >= tiles:
            alive.remove(blk)
    byte = lambda i: buf[i % m] if i < m + 3 else 0  # noqa: E731
    start = np.full(tok_cap, _GARBAGE[0], np.int32)
    count = np.full(tok_cap, _GARBAGE[0], np.int32)
    seg_off = np.full(nb + 1 if table else 0, _GARBAGE[1], np.int32)
    esc_pos = np.full(esc_cap, _GARBAGE[2], np.int32)
    esc_char = np.full(esc_cap, _GARBAGE[3], np.uint8)
    # per tile: its function, its inclusive values, and its max word
    # (inclusive, and the aggregate a slow tile publishes first)
    aggs, incls, maxw = [], [], []
    init = _ch(has=True)
    heads_seen = []
    for j in range(tiles):
        t0 = base + j * T
        fb = {q - t0 for q in fpos if 0 <= q - t0 < T}
        bb = {bnd[s] - t0 for s in bnd if 0 <= bnd[s] - t0 < T}
        # 1. each thread's bytes, its four walks (a warp whose every byte
        # is a 1-byte token inside the stream by the fast path)
        th, pre_walk = [], []
        for t in range(threads):
            i0 = t0 + _PER * t
            b = [byte(i0 + k) for k in range(_PER + 3)]
            ins = {k for k in range(_PER) if lo <= i0 + k < hi}
            pre_walk.append((b, ins, len(ins) == _PER and all(
                _one_byte(x) for x in b[:_PER])))
        lanes = min(_WARP, threads)
        for t in range(threads):
            b, ins, _one = pre_walk[t]
            w0 = t - t % lanes
            fast = all(one for _b, _i, one in pre_walk[w0:w0 + lanes])
            tfb = {k for k in range(_PER) if _PER * t + k in fb}
            tbb = {k for k in range(_PER) if _PER * t + k in bb}
            sm, S, a = _walk4(b, ins, tfb, fast)
            adv = [sum(_token(b[k:k + 4])) - 1 for k in range(_PER)]
            th.append((sm, S, adv, tbb, tfb, a))
        # 2. the maps across the block; the head (entry state still the
        # tile's function), the rest in one channel
        pmap, acc = [], [0, 1, 2, 3]
        for sm, S, *_rest in th:
            pmap.append(acc)
            acc = [S[acc[e]] for e in range(4)]

        def own(t, u):
            """own_sum: the walk's sums, or (a forced restart or a bin
            boundary among the bytes) sum_of's."""
            sm, _S, adv, tbb, tfb, a = th[t]
            if tbb or len(tfb) > 4:
                return _sum_of(adv, sm[u], tbb)
            return (bin(sm[u]).count("1"), a[u], 0, False, False)

        tile_map = acc
        resolved = [len(set(p)) == 1 for p in pmap]
        heads = resolved.count(False)
        assert not any(resolved[:heads]) and all(resolved[heads:])
        heads_seen.append(heads)
        one = [own(t, pmap[t][0]) if resolved[t] else _ch()
               for t in range(threads)]
        vt, vtot = _excl(one)
        head = [_fold(own(t, pmap[t][e]) for t in range(heads))
                for e in range(4)]
        fn = [_combine(head[e], vtot) for e in range(4)]
        aggs.append((tile_map, fn))
        # 3. the look-back: the nearest inclusive record among the window's
        # tiles before (at a random depth), each newer tile's sums in its
        # entry state folded in order
        depth = rng.randint(1, min(_WINDOW, j + 1))
        lanes = []
        for l in range(_WINDOW):
            i = j - 1 - l
            if i < 0:
                lanes.append(None)
            else:
                shown = l == depth - 1 or (l >= depth and rng.random() < 0.5)
                lanes.append((_agg_words(*aggs[i]),
                              _incl_words(*incls[i]) if shown else None))
        x, pre = (0, init) if j == 0 else _wide_lookback(lanes, init)
        tile_end = _combine(pre, fn[x])
        incls.append((tile_map[x], tile_end))
        # 4. each thread's prefix in the true state: past the head, the
        # head's sums and the rest's before it; in the head, the head's
        # threads before it scanned again in the true state
        hx, _ = _excl(own(t, pmap[t][x]) for t in range(heads))
        curs = []
        for t in range(threads):
            cur = (_combine(pre, _combine(head[x], vt[t])) if resolved[t]
                   else _combine(pre, hx[t]))
            curs.append((th[t][0][pmap[t][x]], cur))
        slow = table and tile_end[1] >= 1 << 31
        tok_base = [cur[0] for _m, cur in curs]
        tmaxes = []
        if slow:
            for t, (mask, cur) in enumerate(curs):
                c, a, off, has, pend = cur
                tm = None
                for k in range(_PER):
                    if k in th[t][3]:
                        pend = True
                    if mask >> k & 1:
                        if pend:
                            w = _wrap32(a)
                            tm = w if tm is None else max(tm, w)
                            pend = False
                        a += th[t][2][k]
                tmaxes.append(tm)
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
        elif table:
            maxw.append((_wrap32(tile_end[2]), None))
        for t, (mask, cur) in enumerate(curs):
            c, a, off, has, pend = cur
            if slow:
                run = max([mp] + [v for v in tmaxes[:t] if v is not None])
            for k in range(_PER):
                if k in th[t][3]:
                    pend = True
                if mask >> k & 1:
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
                tok = tok_base[t] + bin(curs[t][0] & ((1 << bit) - 1)).count(
                    "1")
            elif q >= T and j == tiles - 1:
                tok = tile_end[0]
            if tok is not None:
                seg_off[s] = min(tok, tok_cap)
        if table and nb > 0 and j == tiles - 1:
            seg_off[nb] = min(tile_end[0], tok_cap)
    # each block, its tickets done: its share of what no tile writes
    total = incls[-1][1][0]
    reach = min(hi - lo, tok_cap)
    for blk in range(grid):
        if table and blk == 0:
            for s in range(max(nb, 1)):
                if s == 0 or bnd[s] < base:
                    seg_off[s] = 0
        for e0 in range(blk * threads, max(esc_cap, tok_cap),
                        grid * threads):
            for e in range(e0, e0 + threads):
                if e < esc_cap:
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
                if reach + e < tok_cap:
                    start[reach + e] = count[reach + e] = 0
                if min(total, tok_cap) + e < reach:
                    start[min(total, tok_cap) + e] = 0
                    count[min(total, tok_cap) + e] = 0
    if info is not None:
        info.update(taken=taken, heads=heads_seen)
    if not table:
        return start, count
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
