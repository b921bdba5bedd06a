"""The encode's coordinate streams (kernels.coords_emit; csrc/coords.cu on a
card, its plain torch version here) and the first chunk's quality scan
(kernels.qual_stats, csrc/stats.cu) against the JAX package: its
coords_encode2_device (repaq_tpu/ops/device_streams.py) jitted on the
CPU, its host coder kernels_np.encode_coords and its
DeviceEngine.quality_stats; and Python models of the two kernels' tiles
and look-backs. The cases are chip_smoke's COORDS_CASES, placed at the
coordinate kernel's tile of 2,048 elements (runs of 31-33, 64 and 65,
across, ending and starting at tile edges, over 3 tiles and to B; a
leading 1000; n_valid 0, 1, inside a run, at a tile edge and B; wrapping
differences, negative values, values past 2^21), and STATS_CASES at the
scan's tile of 16,384 bases (no N, an N first, last, everywhere, quals >=
128, invalid bases, the first N at a tile edge and in a late tile).
Everything is integer: the tolerance is exact equality."""

import ast
import inspect
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repaq_tpu.codec import kernels_np as K
from repaq_tpu.codec.device_engine import DeviceEngine as JaxEngine
from repaq_tpu.ops import device_streams as D
from repaq_tpu_torch.codec.device_engine import DeviceEngine
from repaq_tpu_torch.format.header import RfqFormatError
from repaq_tpu_torch.ops import device_streams as T
from repaq_tpu_torch.ops import kernels as TK

from chip_smoke import (COORDS_CASES, STATS_CASES, coords_args, coords_case,
                        coords_moved, stats_case, stats_moved)
from test_torch_reference import jax_native  # noqa: F401

# repaq_tpu's native code runs from its source built for this CPU
pytestmark = pytest.mark.usefixtures("jax_native")

TILE = 2048         # csrc/coords.cu's kTile (kernels.coords_tile() on a card)
STATS_TILE = 16384  # csrc/stats.cu's kTile (kernels.stats_tile())
# the cases whose rows the host coder takes (coordinates in [0, 2^21))
HOST_OK = tuple(c for c in COORDS_CASES
                if c not in ("wrap", "negative", "past_2_21"))
_PKG = os.path.dirname(os.path.abspath(T.__file__ + "/.."))


def _jax_coords(xy, out_cap, n_valid):
    out, xl, yl = jax.jit(lambda v: D.coords_encode2_device(
        v, out_cap, n_valid=n_valid))(jnp.asarray(xy))
    return np.asarray(out), int(xl), int(yl)


@pytest.mark.parametrize("valid", ["case", None, 0, 1, "b"])
@pytest.mark.parametrize("name", COORDS_CASES)
def test_coords_cases_match_jax_and_host(name, valid):
    """Each case, with its own n_valid and with None, 0, 1 and B: the
    whole (2 out_cap,) buffer and both lengths equal to JAX's, and each
    row's stream to the host coder's where it takes the row."""
    xy, n_valid = coords_case(name, TILE)
    b = xy.shape[1]
    if valid != "case":
        n_valid = b if valid == "b" else valid
    out_cap = 3 * b + 8
    got, xl, yl = TK.coords_emit(torch.from_numpy(xy), out_cap, n_valid)
    want, wxl, wyl = _jax_coords(xy, out_cap, n_valid)
    assert (int(xl), int(yl)) == (wxl, wyl)
    assert np.array_equal(got.numpy(), want)
    if name in HOST_OK:
        n = b if n_valid is None else max(0, min(n_valid, b))
        for row, ln, base in ((0, wxl, 0), (1, wyl, out_cap)):
            host = K.encode_coords(xy[row, :n].astype(np.int64))
            assert bytes(got.numpy()[base: base + ln]) == host.tobytes()
            assert not got.numpy()[base + ln: base + out_cap].any()


# ---------------------------------------------------------------------------
# a model of csrc/coords.cu: the operator (brk, lead, mid, trail), the
# threads' folds, the tile's scan, the look-back over self-validating
# records (a tile's value at once, its inclusive value later), and each
# thread's walk from the run carried into it
# ---------------------------------------------------------------------------

IDENTITY = (False, 0, 0, 0)


def _ceil32(x):
    return (x + 31) >> 5


def combine(a, b):
    """first a, then b"""
    if not b[0]:
        if not a[0]:
            return (False, a[1] + b[1], 0, a[1] + b[1])
        return (True, a[1], a[2], a[3] + b[1])
    if not a[0]:
        return (True, a[1] + b[1], b[2], b[3])
    return (True, a[1], a[2] + _ceil32(a[3] + b[1]) + b[2], b[3])


def _wrap(x):
    return (x + 2**31) % 2**32 - 2**31


def _kinds(row, n_valid):
    """Each element's kind (rep, delta, abs2, abs3, none) as the kernel
    classifies it."""
    kinds = []
    prev = 1000
    for i, v in enumerate(int(x) for x in row):
        diff = _wrap(v - prev)
        prev = v
        if i >= n_valid:
            kinds.append("none")
        elif diff == 0:
            kinds.append("rep")
        elif 0 < diff <= 64:
            kinds.append("delta")
        else:
            kinds.append("abs2" if v <= 32767 else "abs3")
    return kinds


def _element(kind):
    if kind == "rep":
        return (False, 1, 0, 1)
    return (True, 0, {"delta": 1, "abs2": 2, "abs3": 3}.get(kind, 0), 0)


def _fold(values):
    acc = IDENTITY
    for v in values:
        acc = combine(acc, v)
    return acc


def _look_back(records, j, rng):
    """The prefix before tile j as warp 0 folds it: windows of 32 lanes,
    lane l reading tile hi - l, each tile's inclusive value seen or not at
    random (its own value always), folded from the nearest inclusive one
    up; before tile 0 the identity reads as inclusive."""
    acc = IDENTITY
    hi = j - 1
    while hi >= 0:
        lanes = []
        for lane in range(32):
            k = hi - lane
            if k < 0:
                lanes.append(("incl", IDENTITY))
            elif rng.random() < 0.5:
                lanes.append(("incl", records[k][1]))
            else:
                lanes.append(("agg", records[k][0]))
        nearest = next((i for i, (kind, _v) in enumerate(lanes)
                        if kind == "incl"), None)
        top = 31 if nearest is None else nearest
        acc = combine(_fold(v for _k, v in reversed(lanes[:top + 1])), acc)
        if nearest is not None:
            break
        hi -= 32
    return acc


def model_coords(xy, out_cap, n_valid, threads, per, seed=0):
    """(out, x_len, y_len) of the kernel's tiles of threads x per
    elements, tile by tile, each thread's bytes from its prefix."""
    rng = np.random.default_rng(seed)
    b = xy.shape[1]
    tile = threads * per
    n_valid = b if n_valid is None else max(0, min(n_valid, b))
    out = np.zeros(2 * out_cap, np.uint8)
    lens = []
    for r in range(2):
        row = [int(x) for x in xy[r]]
        kinds = _kinds(row, n_valid)
        tiles = -(-b // tile)
        records = []
        for j in range(tiles):
            own = []
            for t in range(threads):
                lo = j * tile + t * per
                own.append(_fold(_element(kinds[i])
                                 for i in range(lo, min(lo + per, b))))
            total = _fold(own)
            before = _look_back(records, j, rng)
            records.append((total, combine(before, total)))
            thread_before = before
            for t in range(threads):
                lo = j * tile + t * per
                pre = thread_before
                thread_before = combine(thread_before, own[t])
                # the run carried in: its full tokens so far if it goes
                # on, all its bytes if it ended before the thread
                run = pre[3] if pre[0] else pre[1]
                goes_on = lo < b and kinds[lo] == "rep"
                off = ((_ceil32(pre[1]) + pre[2] if pre[0] else 0)
                       + (run >> 5 if goes_on else _ceil32(run)))
                for i in range(lo, min(lo + per, b)):
                    v, k = row[i], kinds[i]
                    prev = row[i - 1] if i else 1000
                    at = r * out_cap + off
                    if k == "rep":
                        run += 1
                        last = i + 1 == b or kinds[i + 1] != "rep"
                        if run % 32 == 0:
                            out[at], off = 0xDF, off + 1
                        elif last:
                            out[at], off = ((run % 32) - 1) | 0xC0, off + 1
                        continue
                    run = 0
                    if k == "delta":
                        out[at], off = ((v - prev - 1) | 0x80) & 0xFF, off + 1
                    elif k == "abs2":
                        out[at:at + 2] = [(v >> 8) & 0xFF, v & 0xFF]
                        off += 2
                    elif k == "abs3":
                        out[at:at + 3] = [((v >> 16) | 0xE0) & 0xFF,
                                          (v >> 8) & 0xFF, v & 0xFF]
                        off += 3
        end = records[-1][1]
        lens.append(_ceil32(end[1]) + end[2] + _ceil32(end[3]) if end[0]
                    else _ceil32(end[1]))
    return out, lens[0], lens[1]


@pytest.mark.parametrize("threads,per", [(1, 1), (1, 2), (2, 1), (1, 3),
                                         (2, 2), (1, 5), (256, 8)])
@pytest.mark.parametrize("name", ["runs", "leading_1000", "run_across_edge",
                                  "run_3_tiles", "run_to_b", "n_valid_0",
                                  "n_valid_in_run", "wrap", "negative",
                                  "past_2_21", "tile+1"])
def test_kernel_model_matches_plain(name, threads, per):
    """The model of the kernel's tile composition, at tiles of 1-5
    elements (with the case's rows cut to 700, so that runs cross many
    tiles and the look-back reads many windows) and at the kernel's own
    tile of 256 threads x 8, gives the plain version's buffer and
    lengths."""
    xy, n_valid = coords_case(name, TILE)
    if threads * per < 8:
        xy = np.ascontiguousarray(xy[:, :700])
        n_valid = None if n_valid is None else min(n_valid, 700)
    out_cap = 3 * xy.shape[1] + 8
    got, xl, yl = model_coords(xy, out_cap, n_valid, threads, per)
    want, wxl, wyl = TK.coords_emit(torch.from_numpy(xy), out_cap, n_valid)
    assert (xl, yl) == (int(wxl), int(wyl))
    assert np.array_equal(got, want.numpy())


def test_combine_is_associative():
    """The look-back folds the operator in any grouping: every grouping of
    random runs of elements gives the sequential fold."""
    rng = np.random.default_rng(3)
    kinds = ["rep", "delta", "abs2", "abs3", "none"]
    for _ in range(300):
        vals = [_element(kinds[k]) for k in
                rng.choice(5, size=int(rng.integers(1, 90)),
                           p=[0.7, 0.1, 0.1, 0.05, 0.05])]
        cuts = sorted(set(rng.integers(0, len(vals), 4).tolist()))
        parts = [vals[a:b] for a, b in zip([0] + cuts, cuts + [len(vals)])]
        assert _fold(_fold(p) for p in parts) == _fold(vals)


# ---------------------------------------------------------------------------
# the quality scan
# ---------------------------------------------------------------------------

# the cases the JAX engine scans here (the 1,100-tile case, 18 Mbase, only
# on a card)
STATS_HERE = tuple(c for c in STATS_CASES if c != "many_tiles")


def _block(seq, qual):
    return types.SimpleNamespace(seq_flat=seq, qual_flat=qual)


def _stats_or_error(fn, block):
    try:
        return fn(block)
    except RfqFormatError as e:
        return ("error", str(e))


@pytest.fixture(scope="module")
def jax_engine():
    return JaxEngine(min_bases=0)


@pytest.mark.parametrize("name", STATS_HERE)
def test_quality_stats_matches_jax(name, jax_engine):
    """The port's DeviceEngine.quality_stats (qual_stats' plain version on
    the CPU) gives the JAX engine's dict: the 128 counts and the N policy
    (no N, an N first and last, all N, quals >= 128 at the first N too),
    or, with invalid bases, the same host route and error."""
    seq, qual = stats_case(name, STATS_TILE)
    block = _block(seq, qual)
    got = _stats_or_error(DeviceEngine("cpu", min_bases=0).quality_stats,
                          block)
    want = _stats_or_error(jax_engine.quality_stats, block)
    if isinstance(want, tuple):
        assert got == want
        return
    assert np.array_equal(got.pop("qual_counts"), want.pop("qual_counts"))
    assert got == want


def model_stats(seq, qual, tile):
    """The kernel's arithmetic: tiles in order, the look-back's "an N
    before", pre (the quals before the first N, from the tiles up to it),
    and the scalars from hist, histN and pre."""
    seq, qual = seq.astype(np.int64), qual.astype(np.int64)
    hist = np.bincount(qual, minlength=256)
    hist_n = np.bincount(qual[seq == ord("N")], minlength=256)
    pre = np.zeros(256, np.int64)
    first = None
    for lo in range(0, seq.shape[0], tile):
        if first is not None:
            break  # every later tile has an N before it
        s = seq[lo:lo + tile]
        at = np.flatnonzero(s == ord("N"))
        cut = int(at[0]) if at.shape[0] else s.shape[0]
        pre += np.bincount(qual[lo:lo + cut], minlength=256)
        if at.shape[0]:
            first = lo + cut
    n_count = int((seq == ord("N")).sum())
    q = int(qual[first if first is not None else 0])
    invalid = int((~np.isin(seq, np.frombuffer(b"ACGTN", np.uint8))).sum())
    nonn = hist[q] - hist_n[q] - pre[q] if n_count else hist[q]
    return np.concatenate([hist[:128], [int(hist[128:].sum()), invalid,
                                        n_count, q, n_count - hist_n[q],
                                        nonn]])


@pytest.mark.parametrize("tile", [1, 3, 64, STATS_TILE])
@pytest.mark.parametrize("name", STATS_HERE)
def test_stats_model_matches_plain(name, tile):
    """The kernel's arithmetic, at tiles of 1, 3, 64 and its own 16,384
    bases, gives qual_stats' 134 words."""
    seq, qual = stats_case(name, STATS_TILE)
    want = TK.qual_stats(torch.from_numpy(seq), torch.from_numpy(qual))
    assert np.array_equal(model_stats(seq, qual, tile), want.numpy())


def test_moved_counts_bytes():
    values2, out_cap, _v = coords_args("tile", TILE)
    assert coords_moved((values2, out_cap, None)) == 8 * TILE + 2 * out_cap + 8
    seq, _q = stats_case("tile", STATS_TILE)
    assert stats_moved(seq) == 2 * STATS_TILE + 8 * 134


# ---------------------------------------------------------------------------
# where the torch code lives
# ---------------------------------------------------------------------------


def _functions_with(text: str) -> set:
    """(module, function) of the innermost functions of the port's torch
    modules (those that import torch) whose source holds text."""
    found = set()
    for root, _dirs, files in os.walk(_PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            with open(path) as fh:
                src = fh.read()
            if text not in src or "import torch" not in src:
                continue
            tree = ast.parse(src)
            for node in ast.walk(tree):
                if isinstance(node, ast.FunctionDef):
                    seg = ast.get_source_segment(src, node)
                    inner = [c for c in ast.walk(node)
                             if isinstance(c, ast.FunctionDef)
                             and c is not node
                             and text in ast.get_source_segment(src, c)]
                    if text in seg and not inner:
                        found.add((os.path.relpath(path, _PKG), node.name))
    return found


@pytest.mark.parametrize("text,where", [
    ("torch.bincount", ("ops/kernels.py", "qual_stats_plain")),
    ("is_abs3", ("ops/device_streams.py", "coords_emit_plain")),
    ("(v >> 16) | 0xE0", ("ops/device_streams.py", "coords_emit_plain")),
])
def test_torch_code_only_in_the_plain_versions(text, where):
    """torch.bincount and the coordinates' classification appear in the
    port's torch modules only in the kernels' plain versions (the
    histogram also in bucket_compact_plain's counts)."""
    found = _functions_with(text)
    assert where in found
    assert all(name.endswith("_plain") for _mod, name in found), found


def test_cuda_paths_call_the_kernels():
    """The engine's quality scan and the coordinate streams call their
    kernels and run no torch compute of their own."""
    scan = inspect.getsource(DeviceEngine.quality_stats)
    assert "kernels.qual_stats(" in scan and "torch." not in scan
    coords = inspect.getsource(T.coords_encode2_device)
    assert "kernels.coords_emit(" in coords and "torch.where" not in coords


@pytest.mark.parametrize("pe", [False, True])
def test_engine_chunk_through_the_kernels(pe, monkeypatch):
    """A header and an SE or PE chunk through DeviceEngine("cpu",
    min_bases=0): one qual_stats call a header, one coords_emit call an
    encode chunk, bytes equal to vectorized's and the input back."""
    from repaq_tpu_torch.codec import vectorized

    from test_device_engine import _mk_block

    calls = {"qual_stats": 0, "coords_emit": 0}
    for name in calls:
        def counted(*a, _name=name, _fn=getattr(TK, name)):
            calls[_name] += 1
            return _fn(*a)
        monkeypatch.setattr(TK, name, counted)
    eng = DeviceEngine("cpu", min_bases=0)
    block = _mk_block(600 if pe else 400, 96, seed=7,
                      pe_overlap=0.5 if pe else 0.0, nfrac=0.01)
    make = eng.config().make_header_pe if pe else eng.config().make_header_se
    header = make(block)
    want = (vectorized.make_header_pe if pe else vectorized.make_header_se)(
        block)
    assert header.to_bytes() == want.to_bytes()
    assert calls == {"qual_stats": 1, "coords_emit": 0}
    got = eng.encode_chunk(header, block, pe)
    assert got.to_bytes() == vectorized.encode_chunk(header, block,
                                                     pe).to_bytes()
    assert calls == {"qual_stats": 1, "coords_emit": 1}
    back = eng.decode_chunk(header, got)
    assert np.array_equal(back.seq_flat, block.seq_flat)
    assert np.array_equal(back.qual_flat, block.qual_flat)


@pytest.mark.parametrize("bad", ["dtype", "1d", "3rows", "empty",
                                 "cap_below_3b", "cap_2_29"])
def test_coords_emit_rejects_bad_arguments(bad):
    v = torch.zeros((2, 8), dtype=torch.int32)
    args = dict(values2=v, out_cap=32)
    args.update({
        "dtype": dict(values2=v.long()),
        "1d": dict(values2=v.reshape(-1)),
        "3rows": dict(values2=torch.zeros((3, 8), dtype=torch.int32)),
        "empty": dict(values2=v[:, :0]),
        "cap_below_3b": dict(out_cap=23),
        "cap_2_29": dict(out_cap=1 << 29),
    }[bad])
    with pytest.raises(ValueError):
        TK.coords_emit(**args)


@pytest.mark.parametrize("bad", ["seq_dtype", "qual_dtype", "2d", "empty",
                                 "lengths"])
def test_qual_stats_rejects_bad_arguments(bad):
    s = torch.full((8,), ord("A"), dtype=torch.uint8)
    args = dict(seq=s, qual=s.clone())
    args.update({
        "seq_dtype": dict(seq=s.int()),
        "qual_dtype": dict(qual=s.int()),
        "2d": dict(seq=s.reshape(2, 4), qual=s.reshape(2, 4)),
        "empty": dict(seq=s[:0], qual=s[:0]),
        "lengths": dict(qual=s[:7]),
    }[bad])
    with pytest.raises(ValueError):
        TK.qual_stats(**args)
