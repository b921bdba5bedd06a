"""The port's stream coders (repaq_tpu_torch/ops/device_streams.py) against
their JAX twins (repaq_tpu/ops/device_streams.py) and the host coders
(repaq_tpu/codec/kernels_np.py), fed the same numpy inputs from a seed.
Everything is integer: the tolerance is exact byte equality, of the whole
padded output buffers where the JAX twin returns one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repaq_tpu.codec import kernels_np as K
from repaq_tpu.format.header import RfqHeader
from repaq_tpu.ops import device_streams as D
from repaq_tpu_torch.codec.device_engine import _bucket
from repaq_tpu_torch.ops import device_streams as T
from test_torch_reference import jax_native  # noqa: F401

# repaq_tpu's native code runs from its source built for this CPU
pytestmark = pytest.mark.usefixtures("jax_native")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(port, jax_out):
    assert np.array_equal(_np(port), np.asarray(jax_out))


@pytest.fixture(params=["narrow", "wide"])
def wide(request, monkeypatch):
    """Both of JAX's emission layouts: 'wide' lowers JAX's _WIDE_THRESHOLD
    so small outputs take its offset-sort form. The port writes each byte
    at its offset in either case and must match both."""
    if request.param == "wide":
        monkeypatch.setattr(D, "_WIDE_THRESHOLD", 64)
    return request.param


def _meta_case(n, seed, n_frac, esc):
    """Meta bytes as the frontend makes them, and the qual they code."""
    rng = np.random.default_rng(seed)
    table = np.array([35, 44, 58], dtype=np.uint8)
    major = 70
    qual = rng.choice(np.concatenate([table, np.full(9, major, np.uint8)]),
                      size=n).astype(np.uint8)
    if esc:
        qual[rng.integers(0, n, size=7)] = 99
    nmask = rng.random(n) < n_frac
    lut = np.full(256, 3, dtype=np.uint8)
    lut[table] = np.arange(3)
    lut[major] = 4
    meta = lut[qual] | (nmask.astype(np.uint8) << 7)
    return meta, qual, table, major, nmask


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_frac", [0.0, 0.001, 0.02, 0.3])
def test_positions_from_meta(wide, n_frac):
    n = 16384
    meta, _q, _t_, _m, nmask = _meta_case(n, 7, n_frac, False)
    npos = int(nmask.sum())
    pos_cap = _bucket(npos, lo=8)
    out_size = _bucket(min(4 * npos, npos + n // 64) + 16, lo=64)
    got, ln = T.encode_positions_from_meta(_t(meta), n, out_size, pos_cap)
    want, wln = jax.jit(lambda m32: D.encode_positions_from_meta32(
        m32, n, out_size, pos_cap=pos_cap))(jnp.asarray(meta.view("<u4")))
    assert int(ln) == int(wln)
    _same(got, want)
    host = K.encode_positions(np.flatnonzero(nmask))
    assert bytes(_np(got)[: int(ln)]) == host.tobytes()


@pytest.mark.parametrize("gap", [127, 128, 129, 16384, 16385])
def test_positions_gap_boundaries(gap):
    n = 16384 * 3
    mask = np.zeros(n, dtype=bool)
    mask[gap] = mask[gap + 1] = True
    mask[gap + 5: gap + 80] = True  # a run of 75: three run tokens
    meta = mask.astype(np.uint8) << 7
    got, ln = T.encode_positions_from_meta(_t(meta), n, 512, 256)
    want, wln = jax.jit(lambda m32: D.encode_positions_from_meta32(
        m32, n, 512, pos_cap=256))(jnp.asarray(meta.view("<u4")))
    assert int(ln) == int(wln)
    _same(got, want)
    host = K.encode_positions(np.flatnonzero(mask))
    assert bytes(_np(got)[: int(ln)]) == host.tobytes()


def test_positions_gap_2_29():
    """A 4-byte gap token of 2^29 (no 2^29-byte mask needed: the sorted
    positions go straight to the shared tail)."""
    n = 1 << 30
    pos = np.array([3, 3 + (1 << 29), 4 + (1 << 29), 9 + (1 << 29)],
                   dtype=np.int32)
    g_pos = np.concatenate([pos, np.full(4, n, np.int32)])
    got, ln = T._positions_from_gpos(_t(g_pos), n, 64, 8)
    want, wln = jax.jit(lambda g: D._positions_from_gpos(g, n, 64, 8))(
        jnp.asarray(g_pos))
    assert int(ln) == int(wln)
    _same(got, want)
    assert bytes(_np(got)[: int(ln)]) == K.encode_positions(pos).tobytes()


@pytest.mark.parametrize("n_frac,esc", [(0.0, False), (0.001, True),
                                        (0.02, False), (0.02, True)])
def test_qualcol_encode(wide, n_frac, esc):
    n = 16384
    meta, qual, table, major, _nm = _meta_case(n, 11, n_frac, esc)
    n_esc = int((qual == 99).sum())
    esc_cap = 0 if n_esc == 0 else _bucket(n_esc, lo=8)
    nm_cap = _bucket(int((qual != major).sum()))
    out_size = 4 * len(table) + n + 8
    got, ln = T.qualcol_encode_device(
        _t(meta), _t(qual), len(table), esc_cap=esc_cap,
        nonmajor_cap=nm_cap, out_size=out_size)
    want, wln = jax.jit(lambda tb, m32, q32: D.qualcol_encode_device(
        None, tb, major, None, esc_cap=esc_cap, nonmajor_cap=nm_cap,
        out_size=out_size, meta32=m32, qual32=q32, n=n))(
        jnp.asarray(table), jnp.asarray(meta.view("<u4")),
        jnp.asarray(qual.view("<u4")))
    assert int(ln) == int(wln)
    _same(got, want)
    host = K.encode_qual_by_col(qual, table, major)
    assert bytes(_np(got)[: int(ln)]) == host.tobytes()


def _coord_values(n, rng):
    vals, last = [], 1000
    for _ in range(n):
        r = rng.random()
        if r < 0.35:
            vals.append(last)
        elif r < 0.65:
            last += int(rng.integers(1, 65))
            vals.append(last)
        else:
            last = int(rng.integers(0, 1 << 21))
            vals.append(last)
    return np.array(vals, dtype=np.int32)


def test_coords_encode2(wide):
    rng = np.random.default_rng(9)
    n, b_cap = 700, 768
    xy = np.zeros((2, b_cap), dtype=np.int32)
    xy[0, :n] = _coord_values(n, rng)
    xy[1, :n] = np.concatenate([np.full(100, 5), np.arange(6, 606)])
    out_cap = 3 * b_cap + 8
    got, xl, yl = T.coords_encode2_device(_t(xy), out_cap, n_valid=n)
    want, wxl, wyl = jax.jit(lambda v: D.coords_encode2_device(
        v, out_cap, n_valid=n))(jnp.asarray(xy))
    assert (int(xl), int(yl)) == (int(wxl), int(wyl))
    _same(got, want)
    got = _np(got)
    for row, ln, base in ((0, int(xl), 0), (1, int(yl), out_cap)):
        host = K.encode_coords(xy[row, :n].astype(np.int64))
        assert bytes(got[base: base + ln]) == host.tobytes()


def test_emission_helpers_match_jax(wide):
    """_classify_stream_positions, _stream_b0 and the three emitters on one
    random grouped position set, element by element."""
    rng = np.random.default_rng(21)
    m, n = 3000, 60000
    g_pos = np.sort(np.concatenate([
        rng.choice(50000, size=m - 100, replace=False),
        np.arange(50000, 50100),  # a long run
    ])).astype(np.int32)
    seg_start = np.zeros(m, dtype=bool)
    seg_start[[0, 1000, 2500]] = True
    is_stream = np.arange(m) < 2900
    got = T._classify_stream_positions(_t(g_pos), _t(seg_start),
                                       _t(is_stream))
    want = jax.jit(D._classify_stream_positions)(
        jnp.asarray(g_pos), jnp.asarray(seg_start), jnp.asarray(is_stream))
    for g, w in zip(got, want):
        _same(g, w)
    b0, counts, ttype = T._stream_b0(*got)
    wb0, wcounts, wttype = jax.jit(D._stream_b0)(*want)
    for g, w in ((b0, wb0), (counts, wcounts), (ttype, wttype)):
        _same(g, w)

    cum = torch.cumsum(counts, 0, dtype=torch.int32)
    offsets, total = cum - counts, cum[-1]
    fields = (got[0] << 2) | ttype
    wfields = (want[0] << 2) | wttype
    wcum = jnp.cumsum(wcounts)
    out_size = int(total) + 40
    _same(T._emit_sort_pay(b0, counts, out_size, offsets, total, m,
                           fields, 4)[0],
          jax.jit(lambda *a: D._emit_sort_pay(
              a[0], a[1], out_size, a[2], a[3], m, a[4], 4)[0])(
              wb0, wcounts, wcum - wcounts, wcum[-1], wfields))

    tail_t = _tail(T, got[0], ttype)
    tail_j = _tail(D, want[0], wttype)
    _same(T._emit_sort_lazy(b0, counts, out_size, offsets, total, m, tail_t,
                            4)[0],
          jax.jit(lambda *a: D._emit_sort_lazy(
              a[0], a[1], out_size, a[2], a[3], m, tail_j, 4)[0])(
              wb0, wcounts, wcum - wcounts, wcum[-1]))

    planes = rng.integers(0, 256, size=(m, 3), dtype=np.uint8)
    pcounts = rng.choice([0, 1, 1, 2, 3], size=m).astype(np.int32)
    extra = ((np.arange(m, dtype=np.int32) + int(pcounts.sum())) << 8) | (
        rng.integers(0, 256, size=m, dtype=np.int32))
    _same(T._emit_sort(_t(planes), _t(pcounts), int(pcounts.sum()) + m + 9,
                       multi_cap=m, extra_keys=_t(extra))[0],
          jax.jit(lambda p, c, e: D._emit_sort(
              p, c, int(pcounts.sum()) + m + 9, multi_cap=m,
              extra_keys=e)[0])(jnp.asarray(planes), jnp.asarray(pcounts),
                                jnp.asarray(extra)))


def _tail(mod, delta, ttype):
    """The gap/run tail lanes of JAX's _stream_tail_fn, written once for
    either package."""
    stack = torch.stack if mod is T else jnp.stack

    def tail(midx):
        t = mod._gather1(ttype, midx)
        v = mod._gather1(delta, midx) - 1
        return stack([(t == 1) * (v & 0xFF) + (t == 2) * ((v >> 16) & 0xFF),
                      (t == 2) * ((v >> 8) & 0xFF), (t == 2) * (v & 0xFF)],
                     1)

    return tail


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("density", [0.001, 0.02, 0.3, 0.95])
def test_decode_positions(density):
    rng = np.random.default_rng(int(density * 1000) + 3)
    n = 20000
    want_pos = np.flatnonzero(rng.random(n) < density)
    enc = K.encode_positions(want_pos)
    buf = np.zeros(n + 8, dtype=np.uint8)  # one shape for every case
    buf[: enc.shape[0]] = enc
    pos, cnt = T.decode_positions_device(_t(buf), enc.shape[0], n)
    wpos, wcnt = jax.jit(D.decode_positions_device, static_argnums=2)(
        jnp.asarray(buf), jnp.int32(enc.shape[0]), n)
    assert int(cnt) == int(wcnt) == want_pos.shape[0]
    _same(pos, wpos)
    assert np.array_equal(_np(pos)[: int(cnt)], want_pos)


def test_decode_positions_gap_2_29_and_restarts():
    """A 2^29 gap token, and two streams decoded in one pass with a forced
    restart at the second one's first byte (positions restart at -1)."""
    a = np.array([5, 5 + (1 << 29), 6 + (1 << 29), 40 + (1 << 29)])
    b = np.array([0, 1, 2, 3, 300, 20000])
    ea, eb = K.encode_positions(a), K.encode_positions(b)
    buf = np.zeros(ea.shape[0] + eb.shape[0] + 8, dtype=np.uint8)
    buf[: ea.shape[0]] = ea
    buf[ea.shape[0]: ea.shape[0] + eb.shape[0]] = eb
    force = np.zeros(buf.shape[0], dtype=bool)
    force[ea.shape[0]] = True
    valid = ea.shape[0] + eb.shape[0]
    pos, cnt = T.decode_positions_device(_t(buf), valid, 16, _t(force))
    wpos, wcnt = jax.jit(D.decode_positions_device, static_argnums=2)(
        jnp.asarray(buf), jnp.int32(valid), 16, jnp.asarray(force))
    assert int(cnt) == int(wcnt) == 10
    _same(pos, wpos)
    assert np.array_equal(_np(pos)[:10], np.concatenate([a, b]))


def _qual_case(seed, n, esc, run_heavy):
    rng = np.random.default_rng(seed)
    if run_heavy:  # 2-bin data: long runs of the minor qual
        qual = np.where((np.arange(n) // 40) % 3 == 0, 50, 70).astype(np.uint8)
        table = np.array([50, 70], dtype=np.uint8)
    else:
        table = rng.choice(np.arange(33, 90, dtype=np.uint8), size=5,
                           replace=False)
        qual = rng.choice(table, size=n)
    if esc:
        qual[rng.integers(0, n, size=6)] = 100
    h = RfqHeader()
    seq = rng.choice(np.frombuffer(b"GATC", dtype=np.uint8),
                     size=2 * len(table))
    h.make_quality_table(seq, np.sort(table.repeat(2)))
    bins = h.normal_qual_buf()
    return qual, bins, h.major_qual()


@pytest.mark.parametrize("run_cap", [None, 4096])
@pytest.mark.parametrize("esc,run_heavy", [(False, False), (True, False),
                                           (True, True)])
def test_qualcol_decode_both_branches(run_cap, esc, run_heavy):
    n = 12000
    qual, bins, major = _qual_case(17, n, esc, run_heavy)
    enc = K.encode_qual_by_col(qual, bins, major)
    buf = np.zeros(2 * n, dtype=np.uint8)  # one shape for every case
    buf[: enc.shape[0]] = enc
    _t_, _c, n_esc = K.qualcol_decode_counts(enc, len(bins))
    # caps are upper bounds: fixed ones keep JAX on one compiled shape
    caps = dict(tok_cap=n, pos_cap=n, esc_cap=8 if n_esc else 0,
                run_cap=run_cap)
    got = T.qualcol_decode_device(_t(buf), len(bins), _t(bins), major, n,
                                  enc.shape[0], **caps)
    want = jax.jit(lambda b, bn, ln: D.qualcol_decode_device(
        b, len(bins), bn, jnp.uint8(major), n, ln, **caps))(
        jnp.asarray(buf), jnp.asarray(bins), jnp.int32(enc.shape[0]))
    _same(got, want)
    assert np.array_equal(_np(got), K.decode_qual_by_col(enc, bins, major, n))
    assert np.array_equal(_np(got), qual)
