"""The run-boundary kernels of the port (``kernels.run_offsets`` and
``kernels.seg_positions``, csrc/scan.cu) against the XLA code of the JAX
package they replace: the ``lax.cummax`` / flipped ``lax.cummin`` pairs and
the arithmetic around them in repaq_tpu/ops/device_streams.py, and the
callers of both packages (``_classify_stream_positions``,
``coords_encode2_device``, ``decode_positions_device`` with
``force_start`` and ``qualcol_decode_device``).

On the CPU the wrappers run their plain torch versions; the CUDA kernels
are held against those in tests/test_torch_cuda.py, on the same seeded
inputs (chip_smoke.run_case and seg_case). Everything is integer: the
tolerance is exact equality."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import RUN_KINDS, SEG_KINDS, run_case, seg_case
from repaq_tpu.codec import kernels_np as K
from repaq_tpu.ops import device_streams as D
from repaq_tpu_torch.ops import device_streams as T
from repaq_tpu_torch.ops import kernels as TK
from test_torch_streams import _qual_case
from test_torch_reference import jax_native  # noqa: F401

# repaq_tpu's native code runs from its source built for this CPU
pytestmark = pytest.mark.usefixtures("jax_native")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_run_offsets(mask):
    """(off, to_end) as the JAX package computes them around its scans:
    off_in_run and covered of `_classify_stream_positions` (:270-282),
    row-wise as `coords_encode2_device` scans (:724-731)."""
    m = jnp.asarray(mask)
    a = m.ndim - 1
    n = m.shape[a]
    i = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32), m.shape)
    prev = jnp.concatenate([jnp.zeros_like(m[..., :1]), m[..., :-1]], a)
    rs_idx = jax.lax.cummax(jnp.where(m & ~prev, i, -1), axis=a)
    off = jnp.where(m, i - rs_idx, 0)
    end_idx = jnp.flip(jax.lax.cummin(jnp.flip(jnp.where(~m, i, n), a),
                                      axis=a), a)
    run_len = jnp.where(m, end_idx - rs_idx, 0)
    return np.asarray(off), np.asarray(jnp.minimum(32, run_len - off))


def _jax_seg_positions(adv, start):
    """raw - seg_base - 1 as `qualcol_decode_device` computes it (:1136-1139)."""
    raw = jnp.cumsum(jnp.asarray(adv))
    seg_base = jax.lax.cummax(jnp.where(jnp.asarray(start),
                                        raw - jnp.asarray(adv), 0))
    return np.asarray(raw - seg_base - 1)


def _check_runs(mask: np.ndarray) -> None:
    before = dict(TK.launches)
    got = TK.run_offsets(_t(mask))
    assert TK.launches == before  # CPU tensors launch nothing
    for g, w in zip(got, _jax_run_offsets(mask)):
        assert g.dtype == torch.int32 and g.shape == mask.shape
        assert np.array_equal(g.numpy(), w)


def _check_segs(adv: np.ndarray, start: np.ndarray) -> None:
    before = dict(TK.launches)
    got = TK.seg_positions(_t(adv), _t(start))
    assert TK.launches == before
    assert got.dtype == torch.int32 and got.shape == adv.shape
    assert np.array_equal(got.numpy(), _jax_seg_positions(adv, start))


@pytest.mark.parametrize("kind", RUN_KINDS)
@pytest.mark.parametrize("rows", [0, 2])
def test_run_offsets_match_jax(kind, rows):
    _check_runs(run_case(5003, rows, kind, seed=len(kind) + rows, tile=1024))


@pytest.mark.parametrize("kind", SEG_KINDS)
def test_seg_positions_match_jax(kind):
    _check_segs(*seg_case(5003, kind, seed=len(kind), tile=512))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 127, 129, 4095, 4097,
                               (1 << 16) - 1, (1 << 16) + 1])
def test_both_match_jax_one_off_a_power_of_two(n):
    _check_runs(run_case(n, 0, "random", seed=n))
    _check_runs(run_case(n, 2, "dense", seed=n))
    _check_segs(*seg_case(n, "random", seed=n))


@pytest.mark.parametrize("shape", [(0,), (2, 0), (0, 7)])
def test_both_of_nothing_are_empty(shape):
    _check_runs(np.zeros(shape, dtype=bool))
    if len(shape) == 1:
        _check_segs(np.zeros(shape, dtype=np.int32), np.zeros(shape, bool))


def test_both_of_one_element():
    for v in (False, True):
        off, to_end = TK.run_offsets(torch.tensor([v]))
        assert off.tolist() == [0] and to_end.tolist() == [int(v)]
    for adv in (-7, 0, 1, (1 << 30) - 1):
        for start in (False, True):
            got = TK.seg_positions(torch.tensor([adv], dtype=torch.int32),
                                   torch.tensor([start]))
            assert got.tolist() == [adv - 1]


def test_both_of_a_strided_view():
    """Non-contiguous inputs (every other column) give what their values
    give."""
    mask = run_case(2 * 999, 2, "dense", seed=3)
    got = TK.run_offsets(torch.from_numpy(mask)[:, ::2])
    want = _jax_run_offsets(np.ascontiguousarray(mask[:, ::2]))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)
    adv, start = seg_case(2 * 999, "random", seed=3)
    got = TK.seg_positions(torch.from_numpy(adv)[::2],
                           torch.from_numpy(start)[::2])
    assert np.array_equal(got.numpy(), _jax_seg_positions(
        np.ascontiguousarray(adv[::2]), np.ascontiguousarray(start[::2])))


_I32 = torch.zeros(8, dtype=torch.int32)
_B = torch.zeros(8, dtype=torch.bool)


@pytest.mark.parametrize("fn,args", [
    (TK.run_offsets, (torch.zeros(8, dtype=torch.int32),)),
    (TK.run_offsets, (torch.zeros(8, dtype=torch.uint8),)),
    (TK.run_offsets, (torch.zeros((2, 2, 2), dtype=torch.bool),)),
    (TK.run_offsets, (torch.tensor(True),)),
    (TK.seg_positions, (_I32.long(), _B)),
    (TK.seg_positions, (_I32, _B.to(torch.uint8))),
    (TK.seg_positions, (_I32.view(2, 4), _B.view(2, 4))),
    (TK.seg_positions, (_I32, _B[:7])),
], ids=["mask_int32", "mask_uint8", "mask_3d", "mask_0d", "adv_int64",
        "start_uint8", "adv_2d", "start_shorter"])
def test_both_reject_other_types_and_ranks(fn, args):
    with pytest.raises(ValueError):
        fn(*args)


def test_both_dispatch_by_device():
    """CPU tensors run the plain versions and launch nothing; a tensor on
    neither the CPU nor a CUDA device, or a mix, raises instead of running
    either version."""
    mask = torch.from_numpy(run_case(100, 0, "random", seed=1))
    adv, start = (torch.from_numpy(a) for a in seg_case(100, "random", 1))
    before = dict(TK.launches)
    for g, w in zip(TK.run_offsets(mask), TK.run_offsets_plain(mask)):
        assert torch.equal(g, w)
    assert torch.equal(TK.seg_positions(adv, start),
                       TK.seg_positions_plain(adv, start))
    assert TK.launches == before
    with pytest.raises(ValueError):
        TK.run_offsets(torch.empty(10, dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError):
        TK.seg_positions(adv, start.to("meta"))
    assert TK.launches == before


# ---------------------------------------------------------------------------
# the callers, against the JAX package's
# ---------------------------------------------------------------------------


def _grouped_positions(seed: int, m: int = 4000):
    """Grouped match positions as the quality stream's grouping sort makes
    them: per segment increasing, with runs of 1-100 adjacent positions
    (31, 32 and 33 among them) between gaps of every token size, and fill
    entries past the stream."""
    rng = np.random.default_rng(seed)
    pos, seg = [], []
    while len(pos) < m:
        p, first = int(rng.integers(0, 3)), True
        for _ in range(int(rng.integers(1, 40))):
            run = int(rng.choice([1, 1, 2, 31, 32, 33, 64, 65,
                                  int(rng.integers(1, 101))]))
            for k in range(run):
                pos.append(p + k)
                seg.append(first)
                first = False
            p += run + int(rng.choice([1, 2, 100, 300, 20000]))
    g_pos = np.array(pos[:m], dtype=np.int32)
    seg_start = np.array(seg[:m])
    is_stream = np.arange(m) < m - 50
    return g_pos, seg_start, is_stream


@pytest.mark.parametrize("seed", [1, 2])
def test_classify_stream_positions_matches_jax(seed):
    """delta, emits_run, covered, g1, g2 and g4 of the port's caller of
    run_offsets equal the JAX package's, element by element."""
    g_pos, seg_start, is_stream = _grouped_positions(seed)
    got = T._classify_stream_positions(_t(g_pos), _t(seg_start),
                                       _t(is_stream))
    want = jax.jit(D._classify_stream_positions)(
        jnp.asarray(g_pos), jnp.asarray(seg_start), jnp.asarray(is_stream))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def _repeat_rows(rng, b: int) -> np.ndarray:
    """(2, b) coordinates with repeats of 1-100 (31, 32, 33, 64 among
    them), steps of every token kind, and repeats across the row end."""
    rows = []
    for _ in range(2):
        vals, v = [], 1000
        while len(vals) < b:
            v = int(rng.choice([v + 1, v + 64, v + 65, max(v - 3, 0), 40000,
                                rng.integers(0, 70000)]))
            vals += [v] * int(rng.choice([1, 1, 31, 32, 33, 64,
                                          rng.integers(1, 101)]))
        rows.append(vals[:b])
    return np.array(rows, dtype=np.int32)


@pytest.mark.parametrize("n_valid", [None, 1500])
def test_coords_encode2_matches_jax(n_valid):
    """The coordinate byte planes, lengths and streams of the port's caller
    of run_offsets equal the JAX package's and the host coder's."""
    b = 2048
    xy = _repeat_rows(np.random.default_rng(5), b)
    out_cap = 3 * b + 8
    got, xl, yl = T.coords_encode2_device(_t(xy), out_cap, n_valid=n_valid)
    want, wxl, wyl = jax.jit(lambda v: D.coords_encode2_device(
        v, out_cap, n_valid=n_valid))(jnp.asarray(xy))
    assert (int(xl), int(yl)) == (int(wxl), int(wyl))
    assert np.array_equal(got.numpy(), np.asarray(want))
    n = b if n_valid is None else n_valid
    for row, ln, base in ((0, int(xl), 0), (1, int(yl), out_cap)):
        host = K.encode_coords(xy[row, :n].astype(np.int64))
        assert bytes(got.numpy()[base: base + ln]) == host.tobytes()


@pytest.mark.parametrize("run_cap", [None, 4096])
def test_qualcol_decode_matches_jax(run_cap):
    """The port's caller of seg_positions on the decode's main path: a
    run-heavy 2-bin quality stream with escapes (long runs, segments of
    both bins) decodes as the JAX package and the host decoder do."""
    n = 12000
    qual, bins, major = _qual_case(23, n, True, True)
    enc = K.encode_qual_by_col(qual, bins, major)
    buf = np.zeros(2 * n, dtype=np.uint8)
    buf[: enc.shape[0]] = enc
    caps = dict(tok_cap=n, pos_cap=n, esc_cap=8, run_cap=run_cap)
    got = T.qualcol_decode_device(_t(buf), len(bins), _t(bins), major, n,
                                  enc.shape[0], **caps)
    want = jax.jit(lambda b, bn, ln: D.qualcol_decode_device(
        b, len(bins), bn, jnp.uint8(major), n, ln, **caps))(
        jnp.asarray(buf), jnp.asarray(bins), jnp.int32(enc.shape[0]))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), qual)


def test_decode_positions_force_start_matches_jax():
    """decode_positions_device's force_start branch, seg_positions' other
    caller: four streams in one pass, restarts at each one's first byte,
    one of them empty of positions past its first."""
    rng = np.random.default_rng(13)
    streams = [np.flatnonzero(rng.random(3000) < d) for d in (0.01, 0.5,
                                                               0.97)]
    streams.append(np.array([0]))
    encs = [K.encode_positions(p) for p in streams]
    valid = sum(e.shape[0] for e in encs)
    buf = np.zeros(valid + 8, dtype=np.uint8)
    force = np.zeros(buf.shape[0], dtype=bool)
    at = 0
    for e in encs:
        buf[at: at + e.shape[0]] = e
        force[at] = True
        at += e.shape[0]
    cap = 8192
    pos, cnt = T.decode_positions_device(_t(buf), valid, cap, _t(force))
    wpos, wcnt = jax.jit(D.decode_positions_device, static_argnums=2)(
        jnp.asarray(buf), jnp.int32(valid), cap, jnp.asarray(force))
    total = sum(p.shape[0] for p in streams)
    assert int(cnt) == int(wcnt) == total
    assert np.array_equal(pos.numpy(), np.asarray(wpos))
    assert np.array_equal(pos.numpy()[:total], np.concatenate(streams))


def test_library_scans_only_in_the_plain_versions():
    """The port calls torch's cummax/cummin nowhere but in the plain
    versions of run_offsets and seg_positions (ops/kernels.py)."""
    pkg = pathlib.Path(T.__file__).resolve().parent.parent
    hits = []
    for path in sorted(pkg.rglob("*.py")):
        for line in path.read_text().splitlines():
            if "torch.cummax" in line or "torch.cummin" in line:
                hits.append((path.relative_to(pkg).as_posix(), line.strip()))
    assert hits == [
        ("ops/kernels.py", "rs_idx = torch.cummax(torch.where(mask & ~prev, "
                           "i, -1), -1).values"),
        ("ops/kernels.py", "end_idx = torch.cummin(torch.where(mask, n, "
                           "i).flip(-1), -1).values.flip(-1)"),
        ("ops/kernels.py", "base = torch.cummax(torch.where(seg_start, raw "
                           "- adv, 0), 0).values"),
    ]
    src = (pkg / "ops" / "kernels.py").read_text()
    for gone in ("cummax_i32", "suffix_min_i32", "repaq_scan_i32"):
        assert gone not in src
