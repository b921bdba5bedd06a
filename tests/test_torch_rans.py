"""The port's `.rfqz` rANS stage (repaq_tpu_torch/ops/rans_device.py) and
its CLI wiring against the JAX module (repaq_tpu/ops/rans_device.py), the
host oracle (repaq_tpu/codec/rans_np.py) and repaq_tpu.cli.

On the CPU the kernel wrappers run their plain torch versions; the CUDA
kernels are held against those in tests/test_torch_cuda.py. Inputs come
from seeds with numpy and go to both packages. Everything is integer: the
tolerance is exact equality."""

import functools
import io
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repaq_tpu.codec import rans_np as R
from repaq_tpu.codec import vectorized
from repaq_tpu.format import rfqz
from repaq_tpu.ops import rans_device as D
from repaq_tpu_torch import cli as tcli
from repaq_tpu_torch.codec import rans_np as TR
from repaq_tpu_torch.ops import _build
from repaq_tpu_torch.ops import kernels as TK
from repaq_tpu_torch.ops import rans_device as T

from chip_smoke import LAYOUT_CASES, _layout_case_makers, layout_case
from test_device_engine import _mk_block

REPO = Path(__file__).resolve().parent.parent
ALPHABET = np.frombuffer(b"\x00\x01\x01\x01\x02\x05\x80\xff\x41\x41", np.uint8)


def _skewed(n, seed):
    return np.random.default_rng(seed).choice(ALPHABET, size=n)


def _markov(n, nsym, base, seed):
    """Strong context dependence over nsym symbols from `base`, as
    tests/test_rans.py::test_device_order1_compact_variants makes it."""
    rng = np.random.default_rng(seed)
    step = (rng.random(n) < 0.3).astype(np.int64)
    return (base + np.cumsum(step) % nsym).astype(np.uint8)


# the input of each branch of the JAX section coder, plus ragged and empty
BRANCHES = {
    "o0_fast_image": (lambda: _skewed(64 * 512, 3), 0, 64),
    "o0_wide": (lambda: np.random.default_rng(1).integers(
        0, 64, size=64 * 300, dtype=np.uint8), 0, 64),
    "o1_compact_no_zero": (lambda: _markov(48 * 256, 4, 65, 2), 1, 32),
    "o1_compact_with_zero": (lambda: _markov(48 * 256, 16, 0, 3), 1, 32),
    "o1_wide": (lambda: _markov(48 * 256, 24, 1, 4), 1, 32),
    "o1_skewed": (lambda: _skewed(64 * 512, 5), 1, 64),
    "single_symbol": (lambda: np.full(32 * 300, 0x42, np.uint8), 0, 32),
    "single_symbol_o1": (lambda: np.full(32 * 300, 0x42, np.uint8), 1, 32),
    "incompressible_o0": (lambda: np.random.default_rng(6).integers(
        0, 256, size=16 * 700, dtype=np.uint8), 0, 16),
    "incompressible_o1": (lambda: np.random.default_rng(7).integers(
        0, 256, size=16 * 700, dtype=np.uint8), 1, 16),
    "ragged_1003": (lambda: _skewed(1003, 4), 0, 64),
    "ragged_1003_o1": (lambda: _skewed(1003, 4), 1, 64),
    "ragged_more_lanes_than_bytes": (lambda: _skewed(37, 8), 1, 64),
    "empty": (lambda: np.zeros(0, np.uint8), 0, 64),
}


def _tables(data, order, lanes):
    """JAX's equal-split tables (build_luts_grid) for data."""
    grid = data.reshape(lanes, -1).T
    return D.build_luts_grid(grid, order)


# ---------------------------------------------------------------------------
# the kernel-level functions against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("lanes", [16, 64])
def test_encode_matches_jax(order, lanes):
    data = _skewed(lanes * 97, lanes + order)
    _h, freqs, cum, _s = _tables(data, order, lanes)
    words, emits, final = T.rans_encode_device(
        torch.from_numpy(data), torch.from_numpy(freqs),
        torch.from_numpy(cum), lanes, order)
    jw, je, jf = jax.jit(D.rans_encode_device, static_argnums=(3, 4))(
        jnp.asarray(data), jnp.asarray(freqs), jnp.asarray(cum), lanes,
        order)
    assert words.dtype == torch.uint16
    assert np.array_equal(words.numpy(), np.asarray(jw))
    assert np.array_equal(emits.numpy(), np.asarray(je))
    assert np.array_equal(final.numpy(), np.asarray(jf).astype(np.int64))


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("lanes", [16, 64])
def test_encode_payload_matches_jax(order, lanes):
    data = _skewed(lanes * 131, 2 * lanes + order)
    _h, freqs, cum, _s = _tables(data, order, lanes)
    out_cap = 2 * data.shape[0] + 4 * lanes + 8
    payload, lane_bytes, total = T.rans_encode_payload_device(
        torch.from_numpy(data), torch.from_numpy(freqs),
        torch.from_numpy(cum), lanes, order, out_cap)
    jp, jl, jt = jax.jit(D.rans_encode_payload_device,
                         static_argnums=(3, 4, 5))(
        jnp.asarray(data), jnp.asarray(freqs), jnp.asarray(cum), lanes,
        order, out_cap)
    assert np.array_equal(payload.numpy(), np.asarray(jp))
    assert np.array_equal(lane_bytes.numpy(), np.asarray(jl))
    assert int(total) == int(jt)


def test_encode_payload_cap_drops_the_tail():
    """Bytes at or past out_cap are dropped, as JAX drops them."""
    data = _skewed(16 * 50, 9)
    _h, freqs, cum, _s = _tables(data, 0, 16)
    args = (torch.from_numpy(data), torch.from_numpy(freqs),
            torch.from_numpy(cum), 16, 0)
    full, _l, total = T.rans_encode_payload_device(*args, 2 * 800 + 72)
    cut = int(total) - 5
    short, _l, _t = T.rans_encode_payload_device(*args, cut)
    jp, _jl, _jt = jax.jit(D.rans_encode_payload_device,
                           static_argnums=(3, 4, 5))(
        jnp.asarray(data), jnp.asarray(freqs), jnp.asarray(cum), 16, 0, cut)
    assert np.array_equal(short.numpy(), full.numpy()[:cut])
    assert np.array_equal(short.numpy(), np.asarray(jp))


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("lanes", [16, 64])
def test_decode_matches_jax_general_path(order, lanes):
    data = _skewed(lanes * 113, 3 * lanes + order)
    enc = R.encode_section(data, order=order, lanes=lanes)
    _h, freqs, cum, sym = _tables(data, order, lanes)
    body = len(_h) + 7
    plen = int.from_bytes(enc[body:body + 4], "little")
    counts = np.frombuffer(enc, "<u4", count=lanes, offset=body + 4)
    payload = np.frombuffer(enc, np.uint8, count=plen,
                            offset=body + 4 + 4 * lanes)
    steps = data.shape[0] // lanes
    grid = T.rans_decode_device(
        torch.from_numpy(payload.copy()),
        torch.from_numpy(counts.astype(np.int64)), torch.from_numpy(sym),
        torch.from_numpy(freqs), torch.from_numpy(cum), lanes, steps, order)
    padded = np.concatenate([payload, np.zeros(2, np.uint8)])
    want = jax.jit(D.rans_decode_device, static_argnums=(5, 6, 7))(
        jnp.asarray(padded), jnp.asarray(counts.astype(np.int32)),
        jnp.asarray(sym), jnp.asarray(freqs), jnp.asarray(cum), lanes,
        steps, order)
    assert np.array_equal(grid.numpy(), np.asarray(want))
    assert np.array_equal(grid.numpy(), data.reshape(lanes, steps).T)


@pytest.mark.parametrize("order", [0, 1])
def test_prologue_matches_build_luts_grid(order):
    """On the equal split the JAX-free prologue builds JAX's tables."""
    data = _skewed(64 * 200, 11 + order)
    head, freqs, cum = T.section_prologue(data, order, 64)
    jhead, jfreqs, jcum, _sym = _tables(data, order, 64)
    assert head[7:] == jhead
    assert np.array_equal(freqs, jfreqs) and np.array_equal(cum, jcum)


@pytest.mark.parametrize("n,lanes", [(1003, 64), (37, 8), (5000, 4096)])
def test_prologue_ragged_matches_host_section(n, lanes):
    """Ragged lanes: the host section's header and tables, with the
    order-1 corrections at the lane starts."""
    data = _skewed(n, n)
    lanes = min(lanes, n)
    head, _f, _c = T.section_prologue(data, 1, lanes)
    assert R.encode_section(data, order=1, lanes=lanes).startswith(head)


def test_lane_offsets_form():
    """Encode splits any n as rans_np.lane_slices does (the rows past a
    shorter lane's end are empty); decode with explicit offsets returns
    the flat bytes."""
    data = _skewed(1003, 12)  # 1003 = 43 * 16 + 21 * 15
    off = R.lane_slices(1003, 64)
    _h, freqs, cum = T.section_prologue(data, 1, 64)
    f, c = torch.from_numpy(freqs), torch.from_numpy(cum)
    d = torch.from_numpy(data)
    words, emits, _final = T.rans_encode_device(d, f, c, 64, 1)
    assert words.shape == (16, 64)
    assert emits[:15].any(0).all()
    assert not emits[15, 43:].any() and not words[15, 43:].any()
    payload, lane_bytes, total = T.rans_encode_payload_device(d, f, c, 64, 1,
                                                              3000)
    sym = np.zeros((256, R.SCALE), np.uint8)
    for k in np.flatnonzero(freqs.any(axis=1)):
        sym[k] = np.repeat(np.arange(256, dtype=np.uint8), freqs[k])
    out = T.rans_decode_device(payload[:int(total)], lane_bytes,
                               torch.from_numpy(sym), f, c, 64, 0, 1,
                               offsets=off)
    assert np.array_equal(out.numpy(), data)
    with pytest.raises(ValueError, match="offsets"):
        T.rans_decode_device(payload, lane_bytes, torch.from_numpy(sym), f, c,
                             64, 0, 1, offsets=off[:-1])


# ---------------------------------------------------------------------------
# the payload layout (rans_layout) on the edges of the kernel's tiles
# ---------------------------------------------------------------------------


def _layout_tile_default():
    """(steps, lanes) of rans_layout's tile in the package build, read from
    the defaults in csrc/rans.cu: the CPU has no build to ask, and the
    card tests place the same cases by the built tile."""
    src = (REPO / "repaq_tpu_torch" / "csrc" / "rans.cu").read_text()
    return tuple(int(re.search(r"#define REPAQ_LAYOUT_%s (\d+)" % k,
                               src).group(1)) for k in ("STEPS", "LANES"))


TILE_T, TILE_W = _layout_tile_default()


def _never_emitting(n, lanes, seed):
    """Order-1 data in an equal split whose lanes i % 3 == 0 hold only 'A'
    and the rest only B, C, D: A's context row is A alone (freq 4096), so
    those lanes never emit."""
    grid = np.random.default_rng(seed).choice(
        np.frombuffer(b"BCD", np.uint8), size=(lanes, n // lanes))
    grid[::3] = ord("A")
    return grid.reshape(-1)


# (steps, lanes, order, data) of the equal splits JAX's payload encoder
# takes: lanes W - 1 .. W + 16, 1003 and 1; steps T - 1 .. 2 T + 1; lanes
# that never emit; a one-symbol section
LAYOUT_JAX_SHAPES = {
    **{"lanes %s" % what: (TILE_T + 1, lanes, lanes % 2, "skewed")
       for what, lanes in (("W - 1", TILE_W - 1), ("W", TILE_W),
                           ("W + 1", TILE_W + 1), ("W + 16", TILE_W + 16),
                           ("1003", 1003), ("one", 1))},
    **{"steps %s" % what: (steps, TILE_W + 1, steps % 2, "skewed")
       for what, steps in (("T - 1", TILE_T - 1), ("T", TILE_T),
                           ("T + 1", TILE_T + 1),
                           ("2 T + 1", 2 * TILE_T + 1))},
    "lanes with no emits": (TILE_T + 1, TILE_W + 1, 1, "never emitting"),
    "a one-symbol section": (TILE_T + 1, TILE_W, 0, "one symbol"),
}


@pytest.mark.parametrize("name", sorted(LAYOUT_JAX_SHAPES))
def test_layout_plain_matches_jax_payload(name):
    """rans_layout_plain (through rans_encode_payload_device) gives JAX's
    payload image on equal splits at the edges of the kernel's tile."""
    steps, lanes, order, kind = LAYOUT_JAX_SHAPES[name]
    n = steps * lanes
    data = {"skewed": lambda: _skewed(n, n),
            "never emitting": lambda: _never_emitting(n, lanes, n),
            "one symbol": lambda: np.full(n, 0x42, np.uint8)}[kind]()
    _h, freqs, cum, _s = _tables(data, order, lanes)
    out_cap = 2 * n + 4 * lanes + 8
    words, emits, final = T.rans_encode_device(
        torch.from_numpy(data), torch.from_numpy(freqs),
        torch.from_numpy(cum), lanes, order)
    assert words.shape == (steps, lanes)
    lane_bytes = 4 + 2 * emits.sum(0)
    start = torch.cumsum(lane_bytes, 0) - lane_bytes
    payload = T.rans_layout_plain(words, emits, final, start, out_cap)
    jp, jl, jt = jax.jit(D.rans_encode_payload_device,
                         static_argnums=(3, 4, 5))(
        jnp.asarray(data), jnp.asarray(freqs), jnp.asarray(cum), lanes,
        order, out_cap)
    assert np.array_equal(payload.numpy(), np.asarray(jp))
    assert np.array_equal(lane_bytes.numpy(), np.asarray(jl))
    if kind == "never emitting":
        assert not emits[:, ::3].any() and emits[:, 1::3].any(0).all()
    if kind == "one symbol":
        assert not emits.any()


def _layout_numpy(words, emits, final, start, cap):
    """rans_layout's contract, a lane at a time: from start[i] the final
    state (4 bytes LE), then the words emitted from the last step down,
    high byte first; bytes at or past cap dropped, every other byte 0."""
    out = np.zeros(cap, np.uint8)
    for i in range(words.shape[1]):
        w = words[emits[:, i], i][::-1].astype(np.int64)
        lane = np.concatenate([(int(final[i]) >> 8 * np.arange(4)) & 0xFF,
                               np.stack([w >> 8, w & 0xFF], 1).reshape(-1)])
        pos = start[i] + np.arange(lane.size)
        keep = pos < cap
        out[pos[keep]] = lane[keep]
    return out


@pytest.mark.parametrize("name", LAYOUT_CASES)
def test_layout_plain_matches_the_contract(name):
    """rans_layout_plain against a numpy statement of the contract on the
    card tests' tile edges: odd and gapped starts, caps through a lane's
    words and through a final state, lanes that never emit."""
    *arrays, cap = layout_case(name, (TILE_T, TILE_W))
    got = T.rans_layout_plain(*(torch.from_numpy(a) for a in arrays), cap)
    assert got.dtype == torch.uint8 and got.shape == (cap,)
    assert np.array_equal(got.numpy(), _layout_numpy(*arrays, cap))


def test_layout_case_names_do_not_depend_on_the_tile():
    """The card tests collect LAYOUT_CASES by name and build each at the
    built tile, so every tile must give the same names."""
    for tile in ((32, 16), (128, 32), (TILE_T, TILE_W), (512, 128)):
        assert sorted(_layout_case_makers(*tile)) == LAYOUT_CASES


# ---------------------------------------------------------------------------
# the reciprocal that takes the division off rans_encode's state chain
# ---------------------------------------------------------------------------

F_ALL = np.arange(1, R.SCALE + 1, dtype=np.uint64)


def _rcp(f):
    m, l = T.rcp_table()[f.astype(np.int64)].T.astype(np.uint64)
    return m, l


def _rcp_div(x, f):
    """x // f by rcp_table, the sum in 33 bits (uint64)."""
    m, l = _rcp(f)
    return (x + ((x * m) >> np.uint64(32))) >> l


def test_rcp_table_meets_the_exactness_condition():
    """Granlund and Montgomery's condition, for every f in 1..4096: with
    M = 2^32 + m, e = M f - 2^(32+l) lies in [1, 2^l], so x e < 2^(32+l)
    for every x < 2^32, and then floor(x M / 2^(32+l)) = x // f."""
    table = T.rcp_table()
    assert table.shape == (R.SCALE + 1, 2) and table.dtype == np.uint32
    assert not table[0].any()
    f = F_ALL.astype(object)
    m, l = (table[1:, 0].astype(object), table[1:, 1].astype(object))
    for fi, mi, li in zip(f, m, l):
        assert (1 << li) >= fi and (li == 0 or (1 << (li - 1)) < fi)
        err = ((1 << 32) + mi) * fi - (1 << (32 + li))
        assert 1 <= err <= (1 << li)
        assert ((1 << 32) - 1) * err < (1 << (32 + li))


def test_rcp_quotient_exact_at_the_edges():
    """q = (x + umulhi(x, m)) >> l and x - q f against x // f and x % f
    for every f: at x = 2^32 - 1 and at q f - 1, q f, q f + 1 for the
    three largest quotients q that keep x below 2^32."""
    f = np.repeat(F_ALL, 10)
    top = np.uint64((1 << 32) - 1) // F_ALL
    x = np.stack([np.full_like(top, (1 << 32) - 1)]
                 + [q * F_ALL + np.uint64(d) - np.uint64(1)
                    for q in (top, top - 1, top - 2) for d in (0, 1, 2)],
                 axis=1).reshape(-1)
    keep = x < np.uint64(1 << 32)
    x, f = x[keep], f[keep]
    assert x.shape[0] > 9 * R.SCALE
    q = _rcp_div(x, f)
    assert np.array_equal(q, x // f)
    assert np.array_equal(x - q * f, x % f)


def test_rcp_quotient_exact_on_random_states():
    """2^16 random x < 2^32, each against 64 values of f, so that every f
    in 1..4096 meets 1,024 of them."""
    x = np.random.default_rng(16).integers(0, 1 << 32, size=1 << 16,
                                           dtype=np.uint64)
    xx = np.repeat(x, 64)
    ff = np.tile(F_ALL, xx.shape[0] // R.SCALE)
    q = _rcp_div(xx, ff)
    assert np.array_equal(q, xx // ff)
    assert np.array_equal(xx - q * ff, xx % ff)


def test_rcp_sum_fits_32_bits_below_the_renormalised_bound():
    """The kernel adds x + umulhi(x, m) in 32 bits. After renormalisation
    x < f << 20, and at the largest such x the sum stays below 2^32 for
    every f (it grows with x), so the 32-bit quotient is exact there."""
    x = (F_ALL << np.uint64(20)) - np.uint64(1)
    m, l = _rcp(F_ALL)
    total = x + ((x * m) >> np.uint64(32))
    assert (total < np.uint64(1 << 32)).all()
    assert np.array_equal(total >> l, x // F_ALL)


def _encode_division_free(data, freqs, cum, lanes, order):
    """rans_encode's arithmetic in numpy uint32, lanes in lockstep: the
    state step with the reciprocal, the sum in 32 bits, as the kernel
    codes it. Returns (words, emits, final) as rans_encode_plain does."""
    n = data.shape[0]
    off = R.lane_slices(n, lanes)
    lens = np.diff(off)
    steps = int(lens.max())
    u32 = np.uint32
    fc = (freqs.astype(np.uint32) | (cum.astype(np.uint32) << u32(16))
          ).reshape(-1)
    rcp = T.rcp_table()
    x = np.full(lanes, R.RANS_L, dtype=u32)
    words = np.zeros((steps, lanes), np.uint16)
    emits = np.zeros((steps, lanes), bool)
    for k in range(steps):
        act = lens > k
        p = np.maximum(off[1:] - 1 - k, 0)
        s = data[p].astype(u32)
        if order:
            prev = np.where(p > off[:-1], data[np.maximum(p - 1, 0)], 0)
            e = fc[(prev.astype(np.int64) << 8) | s]
        else:
            e = fc[s]
        f = e & u32(0xFFFF)
        m, l = rcp[f].T
        emit = act & (x > (f << u32(20)) - u32(1))
        words[k] = np.where(act, x & u32(0xFFFF), 0)
        emits[k] = emit
        xr = np.where(emit, x >> u32(16), x)
        t = ((xr.astype(np.uint64) * m) >> np.uint64(32)).astype(u32)
        q = (xr + t) >> l
        xn = xr + (e >> u32(16)) + q * (u32(R.SCALE) - f)
        x = np.where(act, xn, x)
    return words, emits, x.astype(np.int64)


def _one_rare(n, seed):
    """A symbol seen once among n: quantised to freq 1."""
    data = _skewed(n, seed)
    data[n // 3] = 0x99
    return data


DIVISION_FREE_CASES = {
    "one_symbol_o0": (lambda: np.full(4000, 0x42, np.uint8), 0, 16),
    "one_symbol_o1": (lambda: np.full(4000, 0x42, np.uint8), 1, 16),
    "freq_1_o0": (lambda: _one_rare(50_000, 17), 0, 32),
    "freq_1_o1": (lambda: _one_rare(50_000, 18), 1, 32),
    "skewed_ragged_o0": (lambda: _skewed(3001, 19), 0, 64),
    "markov_ragged_o1": (lambda: _markov(5003, 16, 0, 20), 1, 48),
    "uniform_o0": (lambda: np.random.default_rng(21).integers(
        0, 256, size=16 * 500, dtype=np.uint8), 0, 16),
    "uniform_o1": (lambda: np.random.default_rng(22).integers(
        0, 256, size=20_000, dtype=np.uint8), 1, 8),
}


@pytest.mark.parametrize("case", sorted(DIVISION_FREE_CASES))
def test_division_free_step_matches_plain(case):
    """The kernel's step, division-free, codes whole sections as
    rans_encode_plain's // and % do: words, emits and final states."""
    make, order, lanes = DIVISION_FREE_CASES[case]
    data = make()
    _h, freqs, cum = T.section_prologue(data, order, lanes)
    if case.startswith("one_symbol"):
        assert freqs.max() == R.SCALE
    if case.startswith("freq_1"):
        assert (freqs == 1).any()
    got = _encode_division_free(data, freqs, cum, lanes, order)
    want = T.rans_encode_plain(torch.from_numpy(data),
                               torch.from_numpy(freqs),
                               torch.from_numpy(cum), lanes, order)
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())


# ---------------------------------------------------------------------------
# section drivers: bytes of the host oracle and of JAX on every branch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_encode_section_bytes_match_host_and_jax(branch):
    make, order, lanes = BRANCHES[branch]
    data = make()
    got = T.encode_section_device(data, order=order, lanes=lanes,
                                  device="cpu")
    assert got == R.encode_section(data, order=order, lanes=lanes)
    assert got == D.encode_section_device(data, order=order, lanes=lanes)
    dec, off = T.decode_section_device(got, device="cpu")
    assert dec == data.tobytes() and off == len(got)
    assert D.decode_section_device(got) == (dec, off)


@pytest.mark.parametrize("nsym,base", [(4, 65), (16, 33), (16, 0), (24, 1)])
def test_decode_section_order1_compact_variants(nsym, base):
    """The four inputs of tests/test_rans.py::
    test_device_order1_compact_variants (JAX's compact1 branch with and
    without byte 0, and its gather fallback) through the port's decode."""
    rng = np.random.default_rng(nsym * 131 + base)
    n = 48 * 256
    syms = (base + np.arange(nsym)).astype(np.uint8)
    state = 0
    out = np.empty(n, np.uint8)
    r = rng.random(n)
    for i in range(n):
        state = (state + (1 if r[i] < 0.3 else 0)) % nsym
        out[i] = syms[state]
    enc = R.encode_section(out.tobytes(), order=1, lanes=32)
    dec, off = T.decode_section_device(b"\x07" + enc, 1, device="cpu")
    assert dec == out.tobytes() and off == len(enc) + 1
    assert (dec, off - 1) == D.decode_section_device(enc)


def test_decode_section_errors_match_jax():
    data = _skewed(64 * 40, 13)
    enc = R.encode_section(data, order=0, lanes=64)
    tbl = 7 + len(R.serialize_table(
        R.quantize_freqs(np.bincount(data, minlength=256))))
    for cut in (tbl + 4, len(enc) - 1):
        for dec in (D.decode_section_device,
                    functools.partial(T.decode_section_device,
                                      device="cpu")):
            with pytest.raises(ValueError, match="rANS section truncated"):
                dec(enc[:cut])
        with pytest.raises(TR.RansTruncated):
            T.decode_section_device(enc[:cut], device="cpu")
    bad = bytearray(enc)
    bad[tbl + 4] ^= 0x01  # lane 0's byte count, now odd
    for dec in (D.decode_section_device,
                functools.partial(T.decode_section_device, device="cpu")):
        with pytest.raises(ValueError, match="lane table corrupt"):
            dec(bytes(bad))
    with pytest.raises(TR.RansTruncated):
        T.decode_section_device(enc[:5], device="cpu")


def test_decode_reads_stay_in_bounds():
    """A payload that passed the lane-table checks but holds other bytes,
    and lane counts that run past the payload, decode without reading out
    of bounds (the kernel clamps each lane's reads the same way)."""
    data = _skewed(16 * 300, 14)
    _h, freqs, cum, sym = _tables(data, 1, 16)
    rng = np.random.default_rng(0)
    payload = torch.from_numpy(rng.integers(0, 256, size=700, dtype=np.uint8))
    counts = torch.full((16,), 100, dtype=torch.int64)  # 1600 > 700
    out = T.rans_decode_device(payload, counts, torch.from_numpy(sym),
                               torch.from_numpy(freqs), torch.from_numpy(cum),
                               16, 300, 1)
    assert out.shape == (300, 16)


def test_cpu_tensors_never_reach_the_build(monkeypatch):
    def no_build():
        raise AssertionError("a CPU tensor reached the kernel build")

    monkeypatch.setattr(_build, "library", no_build)
    TK.reset_launches()
    data = _skewed(2000, 15)
    enc = T.encode_section_device(data, order=1, lanes=16, device="cpu")
    assert T.decode_section_device(enc, device="cpu")[0] == data.tobytes()
    assert all(v == 0 for v in TK.launches.values())


def test_mixed_devices_raise():
    d = torch.zeros(10, dtype=torch.uint8, device="meta")
    f = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(ValueError, match="one CUDA device"):
        T.rans_encode_device(d, f, f, 2, 0)


# ---------------------------------------------------------------------------
# the writer and the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pe", [False, True])
def test_writer_with_port_coder_matches_host(pe):
    """RfqzWriter over a real chunk's to_segments() with the port's coder
    on the CPU writes the host coder's bytes; every outer section that
    reached the coder was coded by the port."""
    block = _mk_block(2000, 150, seed=21 + pe, pe_overlap=0.5 if pe else 0)
    header = (vectorized.make_header_pe(block) if pe
              else vectorized.make_header_se(block))
    chunk = vectorized.encode_chunk(header, block, pe)
    calls = []

    def coder(arr, order=0, lanes=R.DEFAULT_LANES):
        calls.append((order, arr.shape[0], lanes))
        return T.encode_section_device(arr, order=order, lanes=lanes,
                                       device="cpu")

    outs = []
    for enc in (None, coder):
        buf = io.BytesIO()
        w = rfqz.RfqzWriter(buf, encode_section=enc)
        w.write(header.to_bytes())
        w.write_segments(chunk.to_segments())
        w.close()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert len(calls) >= 2
    assert any(n % lanes for _o, n, lanes in calls)  # ragged sections too


def test_rfqz_section_coder_binds_the_device_only_under_engine_device():
    assert tcli.rfqz_section_coder("vectorized") is None
    assert tcli.rfqz_section_coder("auto") is None
    coder = tcli.rfqz_section_coder("device")
    assert coder.func is T.encode_section_device
    assert coder.keywords == {"device": "cuda:0"}


def _run(mod, *args):
    r = subprocess.run([sys.executable, "-m", mod, *map(str, args)],
                       env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
                            "JAX_PLATFORMS": "cpu"},
                       capture_output=True)
    return r


@pytest.mark.parametrize("pe", [False, True])
@pytest.mark.parametrize("extra", [[], ["-k", "100"]])
def test_cli_rfqz_matches_jax_cli(fixtures_dir, tmp_path, pe, extra):
    ins = (["-i", fixtures_dir / "pe_big_R1.fq", "-I",
            fixtures_dir / "pe_big_R2.fq"] if pe
           else ["-i", fixtures_dir / "se_big.fq"])
    ours, ref = tmp_path / "port.rfqz", tmp_path / "jax.rfqz"
    r = _run("repaq_tpu_torch.cli", "-c", *ins, "-o", ours, *extra,
             "--engine", "vectorized")
    assert r.returncode == 0, r.stderr
    r = _run("repaq_tpu.cli", "-c", *ins, "-o", ref, *extra)
    assert r.returncode == 0, r.stderr
    assert ours.read_bytes() == ref.read_bytes()
    outs = [tmp_path / "b1.fq", tmp_path / "b2.fq"][:1 + pe]
    dec = ["-o", outs[0]] + (["-O", outs[1]] if pe else [])
    r = _run("repaq_tpu_torch.cli", "-d", "-i", ours, *dec,
             "--engine", "vectorized")
    assert r.returncode == 0, r.stderr
    for back, src in zip(outs, ins[1::2]):
        assert back.read_bytes() == Path(src).read_bytes()
    r = _run("repaq_tpu_torch.cli", "-p", *ins, "-r", ours,
             "--engine", "vectorized")
    assert r.returncode == 0, r.stderr
    assert b'"result":"passed"' in r.stdout


def test_cli_rfqz_chunk_default(tmp_path):
    """Without -k a .rfqz output is cut in 16,000-kb chunks, as the JAX
    CLI cuts it; with the .rfq default of 1,000 kb the bytes differ."""
    rng = np.random.default_rng(31)
    reads, length = 11_000, 100  # 1.1 Mbase: two chunks at 1,000 kb
    seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(reads, length))
    qual = rng.choice(np.frombuffer(b"F:,#", np.uint8), size=(reads, length))
    fq = tmp_path / "in.fq"
    fq.write_bytes(b"".join(b"@r%d\n%s\n+\n%s\n" % (i, s.tobytes(),
                                                    q.tobytes())
                            for i, (s, q) in enumerate(zip(seq, qual))))
    outs = {}
    for name, mod, extra in (("port", "repaq_tpu_torch.cli",
                              ["--engine", "vectorized"]),
                             ("jax", "repaq_tpu.cli", []),
                             ("k1000", "repaq_tpu_torch.cli",
                              ["--engine", "vectorized", "-k", "1000"])):
        out = tmp_path / (name + ".rfqz")
        r = _run(mod, "-c", "-i", fq, "-o", out, *extra)
        assert r.returncode == 0, r.stderr
        outs[name] = out.read_bytes()
    assert outs["port"] == outs["jax"]
    assert outs["port"] != outs["k1000"]


def test_cli_rfqz_engine_device_needs_cuda(fixtures_dir, tmp_path,
                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        tcli.main(["-c", "-i", str(fixtures_dir / "se_big.fq"), "-o",
                   str(tmp_path / "x.rfqz"), "--engine", "device"])
    assert e.value.code != 0
