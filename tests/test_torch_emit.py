"""The encode's gap/run token emission (kernels.qualcol_emit and
kernels.positions_emit; csrc/emit.cu on a card, their plain torch versions
here) against the JAX package's stream coders (repaq_tpu/ops/
device_streams.py: qualcol_encode_device in its meta32 form,
_positions_from_gpos, encode_positions_from_meta32), the host coders
(repaq_tpu.codec.kernels_np: encode_qual_by_col, encode_positions) and
chip_smoke.emit_ref, a numpy loop over the grammar. The cases are
chip_smoke's EMIT_CASES and POS_CASES, placed at the kernel's tile of 2,048
grouped elements: 1 and 124 bins with empty ones, runs of 31, 32, 33 and
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

TILE = 2048  # csrc/emit.cu's kTile (kernels.emit_tile() on a card)
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
