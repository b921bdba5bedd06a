"""The `.rfqz` rANS decode of the port (repaq_tpu_torch/ops/rans_device.py:
rans_decode_plain and decode_table, the packed tables the CUDA kernel
rans_decode reads) on the kernel's edge cases, chip_smoke's DECODE_CASES,
against the host oracle (repaq_tpu/codec/rans_np.py) and the JAX module's
general path (repaq_tpu/ops/rans_device.py:rans_decode_device).

The kernel runs only on a card (tests/test_torch_cuda.py holds it against
rans_decode_plain on the same cases); here a numpy decoder that reads the
packed table step for step as the kernel does (the fields of an entry, its
next row, the output bytes, in both layouts) shows the packing exact
without one.
Inputs come from seeds with numpy; everything is integer, so the
tolerance is exact equality."""

import functools
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repaq_tpu.codec import rans_np as R
from repaq_tpu.ops import rans_device as D
from repaq_tpu_torch.ops import rans_device as T

from chip_smoke import DECODE_CASES, _decode_case_makers, decode_case

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import profile_rans  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
U32 = 0xFFFFFFFF


def _decode_defaults():
    """(window, shared rows) of rans_decode in the package build, from the
    defaults in csrc/rans.cu: the CPU has no build to ask, and the card
    tests place the same cases by the built kernel."""
    src = (REPO / "repaq_tpu_torch" / "csrc" / "rans.cu").read_text()
    ring, rows = (int(re.search(r"#define REPAQ_DEC_%s (\d+)" % k,
                                src).group(1))
                  for k in ("RING", "SHARED_ROWS"))
    return ring // 4 - 4, rows


WINDOW, SHARED_ROWS = _decode_defaults()


@functools.lru_cache(maxsize=None)
def _section(name):
    """(data, the host coder's section, its parts) of a case."""
    order, data, lanes, _shift = decode_case(name, WINDOW, SHARED_ROWS)
    enc = R.encode_section(data, order=order, lanes=lanes)
    return data, enc, T.parse_section(enc)


def _tensors(parts):
    _o, _n, _l, payload, counts, freqs, cum, sym, _off = parts
    return [torch.from_numpy(a) for a in (payload.copy(), counts, sym,
                                          freqs, cum)]


def _decode_packed(payload, counts, table, syms, off):
    """The kernel's decode, lanes in lockstep in numpy: the entry at (row,
    x's slot) gives x' = (freq - 1 + 1) (x >> 12) + (slot - cum) and the
    next row; the output byte is the slot's symbol (the shared route's
    (rows, SCALE) syms) or the next row itself (the global route's, whose
    row r is context r); the word at the lane's position is shifted in
    when x' < 2^16 and the lane holds two more bytes."""
    tab = table.numpy().view(np.uint32).astype(np.int64).reshape(-1)
    plen = payload.shape[0]
    p = np.concatenate([payload.astype(np.int64), [0]])
    end = np.cumsum(counts)
    lane_end = np.minimum(end, plen)
    ptr = end - counts
    x = np.zeros(counts.shape[0], np.int64)
    for b in range(4):
        x |= p[np.where(ptr + b < lane_end, ptr + b, plen)] << (8 * b)
    ptr += 4
    row = np.zeros_like(x)
    lens = np.diff(off)
    out = np.zeros(off[-1], np.uint8)
    for k in range(int(lens.max())):
        act = lens > k
        at = row + (x & 4095)
        e = tab[at]
        q = x >> 12
        y = ((e & 4095) * q + q + (e >> 20)) & U32
        need = act & (y < R.RANS_L) & (ptr + 1 < lane_end)
        w = (p[np.where(need, ptr, plen)] << 8) | p[np.where(need, ptr + 1,
                                                             plen)]
        x = np.where(act, np.where(need, ((y << 16) | w) & U32, y), x)
        ptr = np.where(need, ptr + 2, ptr)
        row = np.where(act, e & 0xFF000, row)
        s = (syms.numpy().reshape(-1)[at] if syms is not None
             else (e >> 12) & 255)
        out[(off[:-1] + k)[act]] = s[act]
    return out


def _layouts(order, freqs):
    """decode_table's `live` for each table layout a section of this order
    can take: the shared route's (the live contexts) and, order-1, the
    global route's (None)."""
    live = T.live_contexts(freqs)
    return (live,) if order == 0 else (live, None)


def test_case_names_do_not_depend_on_the_build():
    """The card tests collect DECODE_CASES by name and build each at the
    built window and shared limit, so every build gives the same names."""
    for window, rows in ((60, 13), (124, 12), (WINDOW, SHARED_ROWS),
                         (252, 11)):
        assert sorted(_decode_case_makers(window, rows)) == DECODE_CASES


@pytest.mark.parametrize("name", DECODE_CASES)
def test_decode_edge_case(name):
    """rans_decode_plain and the numpy decoder of the packed table (in
    each layout the section can take) all give rans_np.decode_section's
    bytes, which are the data; on an equal split JAX's general path
    (jitted, payload padded with 2 zero bytes) gives them too."""
    data, enc, parts = _section(name)
    order, n, lanes = parts[:3]
    off = R.lane_slices(n, lanes)
    payload, counts, sym, freqs, cum = _tensors(parts)
    assert R.decode_section(enc) == (data.tobytes(), len(enc))
    plain = T.rans_decode_plain(payload, counts, sym, freqs, cum, lanes, 0,
                                order, offsets=off)
    assert np.array_equal(plain.numpy(), data)
    for live in _layouts(order, parts[5]):
        table, syms = T.decode_table(sym, freqs, cum, order, live)
        packed = _decode_packed(parts[3], parts[4], table, syms, off)
        assert np.array_equal(packed, data)
    if n % lanes == 0:
        steps = n // lanes
        padded = np.concatenate([parts[3], np.zeros(2, np.uint8)])
        want = jax.jit(D.rans_decode_device, static_argnums=(5, 6, 7))(
            jnp.asarray(padded), jnp.asarray(parts[4].astype(np.int32)),
            jnp.asarray(parts[7]), jnp.asarray(parts[5]),
            jnp.asarray(parts[6]), lanes, steps, order)
        assert np.array_equal(np.asarray(want).T.reshape(-1), data)


@pytest.mark.parametrize("name", DECODE_CASES)
def test_decode_table_fields(name):
    """Every entry of the packed table holds freq - 1, slot - cum and the
    row of the symbol at its slot as the next context. The shared layout
    holds the live contexts' rows, ascending, and each slot's symbol
    beside them, a symbol that is no live context naming the last row;
    the global one all 256 rows, row r being context r, so that the next
    row is the symbol, and no syms. The live count is the case's, the
    same on the host (live_contexts) and read from the tables
    (_live_of)."""
    data, _enc, parts = _section(name)
    order = parts[0]
    freqs, cum, sym = parts[5:8]
    args = [torch.from_numpy(a) for a in (sym, freqs, cum)]
    slot = np.arange(R.SCALE)
    live_ctx = (np.zeros(1, np.int64) if order == 0
                else np.flatnonzero(freqs.any(axis=1)))
    live = live_ctx.size
    assert T.live_contexts(freqs) == T._live_of(args[1], order) == live
    # a live context's row in the shared layout
    number = np.full(256, live - 1)
    number[live_ctx] = np.arange(live)
    for given in _layouts(order, freqs):
        table, syms = T.decode_table(*args, order, given)
        shared = given is not None
        e = table.numpy().view(np.uint32).astype(np.int64)
        assert table.shape == (live if shared else 256, R.SCALE)
        if shared:
            assert syms.shape == (live, R.SCALE)
        else:
            assert syms is None
        for r, ctx in enumerate(live_ctx if shared else range(256)):
            f, c = (freqs, cum) if order == 0 else (freqs[ctx], cum[ctx])
            s = sym[slot] if order == 0 else sym[ctx, slot]
            if not f.any():
                continue  # a context that never occurs: never read
            assert np.array_equal(e[r] & 4095, f[s] - 1)
            assert np.array_equal(e[r] >> 20, slot - c[s])
            nxt = (e[r] >> 12) & 255
            if order == 0:
                assert not nxt.any()
            elif shared:
                assert np.array_equal(nxt, number[s])
            else:
                assert np.array_equal(nxt, s)
            if shared:
                assert np.array_equal(syms[r].numpy(), s)
    kind = _decode_case_makers(WINDOW, SHARED_ROWS)[name][4]
    if order and kind.startswith("symbols "):
        assert live == int(kind.split()[1]) + 1  # context 0 and K bytes
    if order and kind in ("uniform", "one symbol"):
        assert live == {"uniform": 256, "one symbol": 2}[kind]


def test_the_cases_reach_their_edges():
    """The shared limit and one past it, all contexts live, lanes that
    read no word beside lanes that do, and the one-symbol section, whose
    lanes read none."""
    live = {}
    for name in ("o1 live contexts at the shared limit",
                 "o1 live contexts one past the shared limit",
                 "o1 uniform random bytes"):
        _d, _e, parts = _section(name)
        live[name] = int((parts[5] != 0).any(axis=1).sum())
        if name == "o1 uniform random bytes":
            assert (parts[5] != 0).all()
    assert list(live.values()) == [SHARED_ROWS, SHARED_ROWS + 1, 256]
    for order in (0, 1):
        counts = _section("o%d lanes with no renormalisation word"
                          % order)[2][4]
        assert (counts == 4).any() and (counts > 4).any()
        assert (_section("o%d one symbol" % order)[2][4] == 4).all()


def test_decode_table_on_a_corrupt_payload_stays_in_bounds():
    """A payload of other bytes: the packed decode's every read stays in
    the table (every next row is one of its rows, in both layouts) and
    the payload, and the output has the section's length."""
    data, _enc, parts = _section("o1 live contexts at the shared limit")
    order, n, lanes = parts[:3]
    payload = np.random.default_rng(3).integers(0, 256, size=parts[3].size,
                                                dtype=np.uint8)
    for live in _layouts(order, parts[5]):
        table, syms = T.decode_table(
            *(torch.from_numpy(a) for a in (parts[7], parts[5], parts[6])),
            order, live)
        out = _decode_packed(payload, parts[4], table, syms,
                             R.lane_slices(n, lanes))
        assert out.shape == data.shape


def test_offsets_other_than_lane_slices_raise():
    """The section format has one split, rans_np.lane_slices, which the
    kernel computes itself: the decode takes no other offsets, on the CPU
    as on a card."""
    _data, _enc, parts = _section("o1 1003 lanes")
    order, n, lanes = parts[:3]
    off = R.lane_slices(n, lanes).copy()
    off[1] += 1  # still ascending from 0 to n
    for decode in (T.rans_decode_plain, T.rans_decode_device):
        with pytest.raises(ValueError, match="lane_slices"):
            decode(*_tensors(parts), lanes, 0, order, offsets=off)


def test_profile_ablations_match_the_source():
    """tools/profile_rans.py --ablate cuts parts out of csrc/rans.cu by
    text: each anchor must be in the source once, or the card run fails."""
    src = (REPO / "repaq_tpu_torch" / "csrc" / "rans.cu").read_text()
    for cut in (profile_rans.DECODE_ABLATIONS, profile_rans.ABLATIONS,
                profile_rans.LAYOUT_ABLATIONS):
        for name, edits in cut.items():
            for old, _new in edits:
                assert src.count(old) == 1, name
