"""The run writes in the port: ``kernels.fill_runs``' plain version against
a numpy loop on chip_smoke's FILL_CASES in every output type; the sorted
runs' plain versions (``fill_sorted_runs_plain`` against the generic
composition, a filled buffer and each segment's runs, on chip_smoke's
RUNS_CASES and seeded segments; ``concat_row_spans_plain`` against a
row-by-row numpy copy on CONCAT_CASES and against a numpy copy of JAX's
sort by destination on the elision's rows); and their callers
(``qualcol_decode_device``, ``decode_positions_device``, the PE
``_elide``) against the JAX package's, fed the same numpy inputs from a
seed, with the caps the engine gives a chunk. Everything is integer: the
tolerance is exact equality."""

import ast
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (CONCAT_CASES, FILL_CASES, FILL_CHUNK, FILL_DTYPES,
                        RUNS_CASES, chunk_calls, concat_args, concat_case,
                        concat_moved, concat_ref, elide_args, elide_case,
                        elide_sort_ref, fill_args, fill_case,
                        fill_chunk_inputs, fill_loop, fill_moved,
                        parent_elide, parent_qual_fill, parent_qual_write,
                        runs_args, runs_case, runs_moved, runs_ref)
from repaq_tpu.codec import kernels_np as K
from repaq_tpu.format.header import RfqHeader
from repaq_tpu.ops import device_streams as D
from repaq_tpu_torch.codec import device_engine as DE
from repaq_tpu_torch.codec.device_engine import DeviceEngine
from repaq_tpu_torch.ops import device_streams as T
from repaq_tpu_torch.ops import kernels as TK
from test_torch_reference import jax_native  # noqa: F401

# repaq_tpu's native code runs from its source built for this CPU
pytestmark = pytest.mark.usefixtures("jax_native")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("dtype", FILL_DTYPES)
@pytest.mark.parametrize("name", FILL_CASES)
def test_fill_runs_plain_matches_loop(name, dtype):
    """The wrapper on CPU tensors (its plain version) writes what a numpy
    loop writes, leaves the elements before the view alone and launches
    nothing."""
    case = fill_case(name, dtype)
    buf, out, start, count, value, keep = fill_args(case, "cpu")
    before = dict(TK.launches)
    got = TK.fill_runs(out, start, count, value, keep)
    assert TK.launches == before
    assert got.data_ptr() == out.data_ptr()
    off = case[5]
    assert np.array_equal(got.numpy(), fill_loop(case[0][off:], case[1],
                                                 case[2], case[3], case[4]))
    assert np.array_equal(buf.numpy()[:off], case[0][:off])


@pytest.mark.parametrize("bad", ["out_dtype", "value_dtype", "start_dtype",
                                 "keep_shape", "count_neg", "out_2d"])
def test_fill_runs_rejects_bad_arguments(bad):
    out = torch.zeros(16, dtype=torch.uint8)
    start = torch.arange(4, dtype=torch.int32)
    args = dict(out=out, start=start, count=2, value=7, keep=None)
    args.update({
        "out_dtype": dict(out=torch.zeros(16, dtype=torch.int64)),
        "value_dtype": dict(value=torch.zeros(4, dtype=torch.int32)),
        "start_dtype": dict(start=start.long()),
        "keep_shape": dict(keep=torch.ones(3, dtype=torch.bool)),
        "count_neg": dict(count=-1),
        "out_2d": dict(out=torch.zeros(4, 4, dtype=torch.uint8)),
    }[bad])
    with pytest.raises(ValueError):
        TK.fill_runs(**args)


@pytest.mark.parametrize("dtype", FILL_DTYPES)
@pytest.mark.parametrize("name", FILL_CASES)
def test_fill_moved_counts_entry_by_entry(name, dtype):
    """chip_smoke's byte bound for fill_runs, against a loop over the
    entries: keep (or, without it, a count tensor) for every entry, count
    for the kept ones, start and value for those that write, and each
    element written inside the output."""
    case = fill_case(name, dtype)
    _buf, out, start, count, value, keep = fill_args(case, "cpu")
    n, length = start.shape[0], out.shape[0]
    per_count = isinstance(count, torch.Tensor)
    want = n if keep is not None else (4 * n if per_count else 0)
    for i in range(n):
        if keep is not None and not keep[i]:
            continue
        c = int(count[i]) if per_count else int(count)
        want += 4 if per_count and keep is not None else 0
        if c < 1:
            continue
        want += 4 + (value.element_size()
                     if isinstance(value, torch.Tensor) else 0)
        s = int(start[i])
        want += max(0, min(s + c, length) - max(s, 0)) * out.element_size()
    assert fill_moved(out, start, count, value, keep) == want


def test_parent_composition_matches_fill_runs(monkeypatch):
    """chip_smoke's parent composition (the token index_put_ and the run
    grid, which phase 2 times against the kernel) writes what fill_runs
    writes, on FILL_CHUNK's layout cut to 1/256."""
    small = {k: v // 256 for k, v in FILL_CHUNK.items()}
    small["major"] = FILL_CHUNK["major"]
    monkeypatch.setitem(globals(), "FILL_CHUNK", small)
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "FILL_CHUNK", small)
    out, start, count, value, keep = fill_chunk_inputs("cpu")
    assert int(keep.sum()) == small["tokens"]
    assert int(count.sum()) == small["positions"]
    want = parent_qual_fill(out, start, count, value, keep,
                            small["run_cap"])
    got = TK.fill_runs(out.clone(), start, count, value, keep)
    assert torch.equal(got, want)
    assert int((got != small["major"]).sum()) == small["positions"]


# ---------------------------------------------------------------------------
# the sorted runs: fill_sorted_runs and concat_row_spans
# ---------------------------------------------------------------------------

# the CPU places chip_smoke's cases at a small tile (the plain versions
# have none); the card tests place them at the built one
_TILE = 1024


@pytest.mark.parametrize("name", RUNS_CASES)
def test_fill_sorted_runs_plain_matches_the_generic_composition(name):
    """fill_sorted_runs on CPU tensors (its plain version) writes what the
    generic composition writes in numpy (a filled buffer, then each
    segment's runs clipped to it, segment by segment), a new tensor, and
    launches nothing."""
    case = runs_case(name, _TILE)
    args = runs_args(case, "cpu")
    before = dict(TK.launches)
    got = TK.fill_sorted_runs(*args)
    assert TK.launches == before
    assert got.dtype == torch.uint8 and got.shape == (case[0],)
    assert np.array_equal(got.numpy(), runs_ref(*case))


def _random_segments(rng, length):
    """Seeded segments of runs: some empty, starts nondecreasing or (one
    segment in four) shuffled, counts -2..40 with count-0 entries, runs
    past both ends of the output."""
    parts = []
    for _s in range(int(rng.integers(0, 9))):
        n = int(rng.choice([0, 1, 5, int(rng.integers(2, 400))]))
        count = rng.integers(-2, 41, size=n)
        count[rng.random(n) < 0.2] = 0
        start = np.cumsum(rng.integers(0, 60, size=n)) + int(
            rng.integers(-80, length))
        if rng.random() < 0.25:
            start = rng.permutation(start)
        parts.append((start, count))
    seg_off = np.concatenate([[0], np.cumsum([len(p[0]) for p in parts])])
    cat = [np.concatenate([p[i] for p in parts]) if parts else
           np.zeros(0, np.int64) for i in (0, 1)]
    values = rng.integers(0, 256, size=len(parts)).astype(np.uint8)
    return (length, int(rng.integers(0, 256)), cat[0].astype(np.int32),
            cat[1].astype(np.int32), seg_off.astype(np.int32), values)


@pytest.mark.parametrize("seed", range(12))
def test_fill_sorted_runs_plain_on_seeded_segments(seed):
    """The plain version against the generic composition on seeded random
    segments (lengths that are no multiple of 16 among them)."""
    rng = np.random.default_rng(4200 + seed)
    case = _random_segments(rng, int(rng.integers(1, 5000)))
    got = TK.fill_sorted_runs(*runs_args(case, "cpu"))
    assert np.array_equal(got.numpy(), runs_ref(*case))


def test_fill_sorted_runs_reads_offsets_clamped_and_raised():
    """segment_bounds, the offsets as the kernels read them: clamped to
    [0, n], each raised to the largest before it."""
    seg_off = torch.tensor([-5, 300, 200, 900, 50, 700], dtype=torch.int32)
    assert TK.segment_bounds(seg_off, 700) == [0, 300, 300, 700, 700, 700]


@pytest.mark.parametrize("bad", ["start_dtype", "count_shape", "off_shape",
                                 "value_dtype", "too_many", "background",
                                 "length"])
def test_fill_sorted_runs_rejects_bad_arguments(bad):
    i32 = torch.int32
    args = dict(length=64, background=7, start=torch.zeros(4, dtype=i32),
                count=torch.ones(4, dtype=i32),
                seg_off=torch.tensor([0, 4], dtype=i32),
                seg_value=torch.tensor([9], dtype=torch.uint8))
    args.update({
        "start_dtype": dict(start=torch.zeros(4, dtype=torch.int64)),
        "count_shape": dict(count=torch.ones(5, dtype=i32)),
        "off_shape": dict(seg_off=torch.tensor([0, 2, 4], dtype=i32)),
        "value_dtype": dict(seg_value=torch.tensor([9], dtype=i32)),
        "too_many": dict(seg_off=torch.zeros(258, dtype=i32),
                         seg_value=torch.zeros(257, dtype=torch.uint8)),
        "background": dict(background=256),
        "length": dict(length=-1),
    }[bad])
    with pytest.raises(ValueError):
        TK.fill_sorted_runs(**args)


@pytest.mark.parametrize("name", CONCAT_CASES)
def test_concat_row_spans_plain_matches_rows(name):
    """concat_row_spans on CPU tensors (its plain version) writes what a
    row-by-row numpy copy writes (strided source rows, clipped columns and
    destinations, rows out of order) and launches nothing."""
    case = concat_case(name, _TILE)
    args = concat_args(case, "cpu")
    before = dict(TK.launches)
    got = TK.concat_row_spans(*args)
    assert TK.launches == before
    assert np.array_equal(got.numpy(), concat_ref(*case))


_ELIDE_KINDS = ("ov0", "fwd127", "bwd127", "mixed", "odd_reads", "no_reads",
                "pad_rows", "full_overlap")


@pytest.mark.parametrize("kind", _ELIDE_KINDS)
def test_elision_matches_jax_sort_by_destination(kind):
    """The port's _elide, and concat_row_spans_plain on its rows, against a
    numpy copy of JAX's elision (a stable sort of destination keys and
    bytes, 'G' past the stored count), at ov = 0, +-127, mixed, an odd read
    count, no reads, pad rows and whole overlaps."""
    tseq, ov, n_reads = elide_case(kind)
    want, total = elide_sort_ref(tseq, ov, n_reads)
    got = TK.concat_row_spans_plain(*concat_args(elide_args(tseq, ov,
                                                            n_reads), "cpu"))
    assert np.array_equal(got.numpy(), want)
    seq, stored = DE._elide(_t(tseq), _t(ov), n_reads)
    assert np.array_equal(seq.numpy(), want) and int(stored) == total
    pseq, pstored = parent_elide(_t(tseq), _t(ov), n_reads)
    assert torch.equal(pseq, seq) and int(pstored) == total


@pytest.mark.parametrize("bad", ["src_dtype", "src_rows", "span_shape",
                                 "dest_dtype", "background"])
def test_concat_row_spans_rejects_bad_arguments(bad):
    i32 = torch.int32
    src = torch.zeros(4, 8, dtype=torch.uint8)
    args = dict(src=src, src_start=torch.zeros(4, dtype=i32),
                span=torch.ones(4, dtype=i32),
                dest_off=torch.arange(4, dtype=i32), length=16,
                background=71)
    args.update({
        "src_dtype": dict(src=src.to(i32)),
        "src_rows": dict(src=src.t()),
        "span_shape": dict(span=torch.ones(3, dtype=i32)),
        "dest_dtype": dict(dest_off=torch.arange(4)),
        "background": dict(background=-1),
    }[bad])
    with pytest.raises(ValueError):
        TK.concat_row_spans(**args)


@pytest.mark.parametrize("name", RUNS_CASES[:9])
def test_runs_moved_counts_entry_by_entry(name):
    """chip_smoke's byte bound for fill_sorted_runs: the output once, start
    and count of every entry inside the segments, the offsets and
    values."""
    length, _bg, start, count, seg_off, seg_value = runs_args(
        runs_case(name, _TILE), "cpu")
    b = TK.segment_bounds(seg_off, start.shape[0])
    want = (length + sum(8 * (b[s + 1] - b[s]) for s in range(
        seg_value.shape[0])) + 4 * seg_off.shape[0] + seg_value.shape[0])
    assert runs_moved(length, start, seg_off, seg_value) == want


@pytest.mark.parametrize("name", ["ov0", "mixed", "strided", "src_clip",
                                  "dest_clip"])
def test_concat_moved_counts_row_by_row(name):
    """chip_smoke's byte bound for concat_row_spans: the output once, each
    copied source byte and three int32 a row."""
    case = concat_case(name, _TILE)
    src, src_start, span, dest_off, length, bg = case
    # a byte is written where the two backgrounds leave it the same
    copied = int((concat_ref(src, src_start, span, dest_off, length, 0)
                  == concat_ref(src, src_start, span, dest_off, length, 1)
                  ).sum())
    assert concat_moved(*concat_args(case, "cpu")[:5]) == (
        length + copied + 12 * src.shape[0])


def test_parent_compositions_match_the_sorted_runs():
    """chip_smoke's parent compositions (timed against the kernels in
    turns on the card) write what the new entries write, at the quality
    call of one SE chunk recorded through the CLI on the CPU (2,000
    reads) and on one segment of runs."""
    calls = chunk_calls("cpu", 2_000)["fill_sorted_runs"]
    assert len(calls) == 1
    args = calls[0]
    assert torch.equal(parent_qual_write(*args)(),
                       TK.fill_sorted_runs(*args))
    # where runs of two segments meet, the parent's one scatter may land
    # either value: compare on a segment alone
    case = runs_case("one_segment", _TILE)
    args = runs_args(case, "cpu")
    assert np.array_equal(parent_qual_write(*args)().numpy(),
                          runs_ref(*case))


def test_quality_write_and_elision_are_one_call_each():
    """qualcol_decode_device writes its token runs with one
    fill_sorted_runs call (no torch.full of the output, no per-token
    value gather; fill_runs only for the escapes, in _scatter_escapes),
    and _elide with one concat_row_spans call (no index_put_, no
    torch.full)."""
    pkg = pathlib.Path(T.__file__).resolve().parent.parent
    calls = {}
    for path, name in (("ops/device_streams.py", "qualcol_decode_device"),
                       ("ops/device_streams.py", "_scatter_escapes"),
                       ("codec/device_engine.py", "_elide")):
        tree = ast.parse((pkg / path).read_text())
        fn = next(n for n in ast.walk(tree)
                  if isinstance(n, ast.FunctionDef) and n.name == name)
        calls[name] = [c.func.attr for c in ast.walk(fn)
                       if isinstance(c, ast.Call)
                       and isinstance(c.func, ast.Attribute)]
        assert not [a for a in ast.walk(fn) if isinstance(a, ast.Assign)
                    and isinstance(a.targets[0], ast.Subscript)
                    and name != "qualcol_decode_device"]
    q = calls["qualcol_decode_device"]
    assert q.count("fill_sorted_runs") == 1 and "fill_runs" not in q
    assert "full" not in q and "bin_chars" not in str(q)
    assert calls["_scatter_escapes"].count("fill_runs") == 1
    e = calls["_elide"]
    assert e.count("concat_row_spans") == 1
    assert "full" not in e and "index_put_" not in e


def _stream_bytes(tokens):
    """A position stream's bytes: ("gap", d) for a gap token of distance
    d (1, 2 or 4 bytes by size), ("run", k) for a run of k positions."""
    out = bytearray()
    for kind, v in tokens:
        if kind == "run":
            out.append(0xC0 | (v - 1))
        elif v <= 0x80:
            out.append(v - 1)
        elif v <= 0x4000:
            out += bytes([0x80 | ((v - 1) >> 8), (v - 1) & 0xFF])
        else:
            out += bytes([0xE0 | ((v - 1) >> 24), ((v - 1) >> 16) & 0xFF,
                          ((v - 1) >> 8) & 0xFF, (v - 1) & 0xFF])
    return bytes(out)


@pytest.mark.parametrize("branch", ["slot", "token"])
def test_qualcol_decode_with_a_wrapping_bin(branch):
    """A corrupt by-column stream whose second bin's int32 positions wrap:
    bin 0 writes even positions and a run, bin 1 the odd ones up to P, then 8
    gap-4 tokens (dropped targets past the output and below 0) bring its
    positions round 2^32 back to 1, and it writes the odd positions again.
    kernels_np.qualcol_decode_counts takes the stream; the decode gives
    the generic composition's bytes (each bin's runs over the major, bin
    by bin) and, on JAX's token-space branch, JAX's bytes."""
    length, p = 6000, 4001
    even = [("gap", 1)] + [("gap", 2)] * 1500 + [("gap", 2000), ("run", 5)]
    odd = [("gap", 2)] * (1 + (p - 1) // 2)
    jumps = [1 << 29] * 7 + [(1 << 29) - (p - 1)]
    odd += [("gap", d) for d in jumps] + [("gap", 2)] * 700
    streams = [_stream_bytes(even), _stream_bytes(odd)]
    enc = np.frombuffer(b"".join(len(x).to_bytes(4, "little")
                                 for x in streams) + b"".join(streams),
                        np.uint8)
    bins = np.frombuffer(b"#,", np.uint8)
    major = ord("F")
    t, _c, _e = K.qualcol_decode_counts(enc, 2)
    buf = np.zeros(enc.shape[0] + 64, np.uint8)
    buf[: enc.shape[0]] = enc
    caps = dict(tok_cap=t + 100, pos_cap=1 << 14, esc_cap=4,
                run_cap=None if branch == "slot" else t + 100)
    got = T.qualcol_decode_device(_t(buf), 2, _t(bins), major, length,
                                  enc.shape[0], **caps).numpy()
    want = np.full(length, major, np.uint8)
    want[0:3001:2] = bins[0]
    want[5000:5006] = bins[0]
    want[1:p + 1:2] = bins[1]
    assert np.array_equal(got, want)
    if branch == "token":
        jgot = jax.jit(lambda b, bn, ln: D.qualcol_decode_device(
            b, 2, bn, jnp.uint8(major), length, ln, **caps))(
            jnp.asarray(buf), jnp.asarray(bins), jnp.int32(enc.shape[0]))
        assert np.array_equal(got, np.asarray(jgot))


# ---------------------------------------------------------------------------
# the callers against the JAX package
# ---------------------------------------------------------------------------


def _qual_stream(density, esc, n, seed):
    """A quality column of n chars and its palette: NovaSeq-like (4 bins,
    ~14% non-major), sparse (~1% non-major), dense (~60% non-major), 40
    bins (a HiSeq-like spread), or run-heavy (2 bins, runs of 40 of the
    minor qual), with 9 escapes if esc."""
    rng = np.random.default_rng(seed)
    if density in ("nova", "sparse", "dense"):
        p = {"nova": [0.01, 0.04, 0.09, 0.86],
             "sparse": [0.001, 0.003, 0.006, 0.99],
             "dense": [0.1, 0.2, 0.3, 0.4]}[density]
        qual = rng.choice(np.frombuffer(b"#,:F", np.uint8), size=n, p=p)
    elif density == "bins40":
        w = np.linspace(1, 3, 40) ** 3
        qual = rng.choice(np.arange(33, 73, dtype=np.uint8), size=n,
                          p=w / w.sum())
    else:
        qual = np.where((np.arange(n) // 40) % 3 == 0, 50, 70).astype(
            np.uint8)
        qual[rng.integers(0, n, size=n // 50)] = 50
    h = RfqHeader()
    h.make_quality_table(rng.choice(np.frombuffer(b"GATC", np.uint8),
                                    size=n), qual)
    if esc:  # chars outside the palette built above
        qual[rng.integers(0, n, size=9)] = 100
    return qual, h.normal_qual_buf(), h.major_qual()


@pytest.mark.parametrize("branch", ["slot", "token"])
@pytest.mark.parametrize("esc", [False, True])
@pytest.mark.parametrize("density", ["nova", "run_heavy", "sparse", "dense",
                                     "bins40"])
def test_qualcol_decode_matches_jax_at_engine_caps(density, esc, branch):
    """qualcol_decode_device against JAX's with the caps the engine gives a
    chunk padded to n_cap (DeviceEngine._decode_caps): tok_cap well above
    the tokens and, for JAX's token-space branch, run_cap from its ladder
    (n_cap / 16 at least, the shape of the parent's 73 M-entry grid at a
    12-Mbase chunk), else None (JAX's slot-space branch). The port's bytes
    are the same in both: run_cap selects nothing there."""
    n_cap = 1 << 16
    n = n_cap - 1000
    qual, bins, major = _qual_stream(density, esc, n, 31)
    enc = K.encode_qual_by_col(qual, bins, major)
    nbins = len(bins)
    chunk = types.SimpleNamespace(qual_buf=enc.tobytes())
    qb_cap, _nb, _np, (tok_cap, pos_cap, esc_cap, run_cap) = \
        DeviceEngine._decode_caps(n_cap, enc.shape[0], 0, chunk, nbins)
    t, _c, _e = K.qualcol_decode_counts(enc, nbins)
    assert tok_cap >= 2 * t or tok_cap >= n_cap // 16
    if branch == "token":
        # run-heavy chunks get None from the engine; a token count bounds
        # the 4-token groups holding a run, so tok_cap drops none
        run_cap = tok_cap if run_cap is None else run_cap
        assert run_cap >= n_cap // 16
    else:
        run_cap = None
    buf = np.zeros(qb_cap, dtype=np.uint8)
    buf[: enc.shape[0]] = enc
    caps = dict(tok_cap=tok_cap, pos_cap=pos_cap, esc_cap=esc_cap,
                run_cap=run_cap)
    got = T.qualcol_decode_device(_t(buf), nbins, _t(bins), major, n_cap,
                                  enc.shape[0], **caps)
    want = jax.jit(lambda b, bn, ln: D.qualcol_decode_device(
        b, nbins, bn, jnp.uint8(major), n_cap, ln, **caps))(
        jnp.asarray(buf), jnp.asarray(bins), jnp.int32(enc.shape[0]))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy()[:n], qual)


@pytest.mark.parametrize("forced", [False, True])
@pytest.mark.parametrize("density", [0.001, 0.05, 0.9])
def test_decode_positions_matches_jax(density, forced):
    """decode_positions_device (its deltas and, with force_start, segment
    marks written by fill_runs) against JAX's, on gap, long-gap and run
    tokens; with force_start, three streams in one pass."""
    rng = np.random.default_rng(int(density * 1000) + forced)
    streams = [np.flatnonzero(rng.random(20000) < density)]
    if forced:
        streams += [np.array([3, 4, 5, 1 << 20]),
                    np.flatnonzero(rng.random(5000) < 0.5)]
    encs = [K.encode_positions(p) for p in streams]
    valid = sum(e.shape[0] for e in encs)
    buf = np.zeros(valid + 8, dtype=np.uint8)
    force = np.zeros(buf.shape[0], dtype=bool)
    at = 0
    for e in encs:
        buf[at: at + e.shape[0]] = e
        force[at] = True
        at += e.shape[0]
    total = sum(p.shape[0] for p in streams)
    cap = 1 << (max(total, 1) - 1).bit_length()
    fs = force if forced else None
    pos, cnt = T.decode_positions_device(
        _t(buf), valid, cap, None if fs is None else _t(fs))
    wpos, wcnt = jax.jit(D.decode_positions_device, static_argnums=2)(
        jnp.asarray(buf), jnp.int32(valid), cap,
        None if fs is None else jnp.asarray(fs))
    assert int(cnt) == int(wcnt) == total
    assert np.array_equal(pos.numpy(), np.asarray(wpos))
    assert np.array_equal(pos.numpy()[:total], np.concatenate(streams))


def test_decode_writes_have_no_dump_slot():
    """The port's decode writes go through kernels.fill_runs: in
    decode_positions_device, _scatter_escapes, qualcol_decode_device and
    DeviceEngine._decode_step the only subscript assignments left are the
    stream-start marks (one a bin); the PE revcomp's row copies went into
    kernels.pe_decode_rows."""
    pkg = pathlib.Path(T.__file__).resolve().parent.parent
    found = {}
    for path, names in (("ops/device_streams.py",
                         ("decode_positions_device", "_scatter_escapes",
                          "qualcol_decode_device")),
                        ("codec/device_engine.py", ("_decode_step",))):
        tree = ast.parse((pkg / path).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.FunctionDef) and node.name in names:
                found[node.name] = sorted(
                    ast.unparse(t) for a in ast.walk(node)
                    if isinstance(a, ast.Assign) for t in a.targets
                    if isinstance(t, ast.Subscript))
    assert found == {
        "decode_positions_device": [],
        "_scatter_escapes": [],
        "qualcol_decode_device": ["force[stream_begin.clamp(0, m).long()]"],
        "_decode_step": [],
    }
