"""The decode's masked run writes in the port: ``kernels.fill_runs``' plain
version against a numpy loop on chip_smoke's FILL_CASES in every output
type, and its callers (``qualcol_decode_device``, ``decode_positions_device``)
against the JAX package's, fed the same numpy inputs from a seed, with the
caps the engine gives a chunk. Everything is integer: the tolerance is
exact equality."""

import ast
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (FILL_CASES, FILL_CHUNK, FILL_DTYPES, fill_args,
                        fill_case, fill_chunk_inputs, fill_loop, fill_moved,
                        parent_qual_fill)
from repaq_tpu.codec import kernels_np as K
from repaq_tpu.format.header import RfqHeader
from repaq_tpu.ops import device_streams as D
from repaq_tpu_torch.codec.device_engine import DeviceEngine
from repaq_tpu_torch.ops import device_streams as T
from repaq_tpu_torch.ops import kernels as TK


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
# the callers against the JAX package
# ---------------------------------------------------------------------------


def _qual_stream(density, esc, n, seed):
    """A quality column of n chars and its palette: NovaSeq-like (4 bins,
    ~14% non-major) or run-heavy (2 bins, runs of 40 of the minor qual),
    with 9 escapes if esc."""
    rng = np.random.default_rng(seed)
    if density == "nova":
        qual = rng.choice(np.frombuffer(b"#,:F", np.uint8), size=n,
                          p=[0.01, 0.04, 0.09, 0.86])
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
@pytest.mark.parametrize("density", ["nova", "run_heavy"])
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
    stream-start marks (one a bin) and the PE revcomp's row copies."""
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
        "_decode_step": ["qm[1::2]", "sm[1::2]"],
    }
