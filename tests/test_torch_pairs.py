"""The PE pair kernels' plain versions in the port against the JAX package,
on the CPU: ``kernels.pe_encode_pairs`` (the odd rows' revcomp, the overlap
search and the shift clamp, in place) against the JAX encode step's pieces
(repaq_tpu/codec/device_engine.py:580-591: ``jnp.where(odd,
comp(flip))`` and ``repaq_tpu.ops.device_streams.overlap_pairs_device``
with the step's mask and clamp), and ``kernels.pe_decode_rows`` (the
overlap expansion, N restore, revcomp and payload) against the JAX decode
step's expressions (:984-1021), on chip_smoke's PAIR_CASES, OVERLAP_CASES
and PE chunk grid at small sizes, and on tables recorded from real
encoded chunks. The CUDA kernels are held against the same plain versions
in tests/test_torch_cuda.py. Inputs are made with numpy from seeds;
everything is bytes: the tolerance is exact equality."""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (OVERLAP_CASES, PAIR_CASES, comp_np, decode_inputs,
                        overlap_case, pair_case, pairs_moved,
                        parent_pe_decode, parent_pe_encode, pe_overlap_grid,
                        rows_moved, wild_tables)
from repaq_tpu.codec import oracle
from repaq_tpu.codec.device_engine import DeviceEngine as JaxEngine
from repaq_tpu.codec import vectorized as jax_vectorized
from repaq_tpu.ops import device_streams as D
from repaq_tpu_torch.codec import device_engine as TE
from repaq_tpu_torch.codec import vectorized
from repaq_tpu_torch.ops import kernels as TK

from test_device_engine import _mk_block

REPO = pathlib.Path(__file__).resolve().parent.parent
ACGTN = np.frombuffer(b"ACGTN", np.uint8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_comp(x):
    """The JAX PE steps' complement (ACGT only; other bytes kept),
    repaq_tpu/codec/device_engine.py:569-577 and :963-969."""
    return jnp.where(
        x == ord("A"), ord("T"),
        jnp.where(x == ord("T"), ord("A"),
                  jnp.where(x == ord("C"), ord("G"),
                            jnp.where(x == ord("G"), ord("C"), x))),
    ).astype(jnp.uint8)


@jax.jit
def _jax_transform(seq_mat, qual_mat):
    odd = (jnp.arange(seq_mat.shape[0]) % 2 == 1)[:, None]
    tseq = jnp.where(odd, _jax_comp(jnp.flip(seq_mat, axis=1)), seq_mat)
    tqual = jnp.where(odd, jnp.flip(qual_mat, axis=1), qual_mat)
    return tseq, tqual


def _jax_ov(tseq, n_pairs, shift, search):
    """The JAX encode step's ov: the hash search on the transformed rows,
    the pairs past n_pairs masked, then the shift clamp (:587-591)."""
    p_cap = tseq.shape[0] // 2
    if not search:
        return np.zeros(p_cap, np.int32)
    ov, coll = jax.jit(D.overlap_pairs_device)(jnp.asarray(tseq[0::2]),
                                               jnp.asarray(tseq[1::2]))
    pvalid = jnp.arange(p_cap) < n_pairs
    assert not np.asarray(coll & pvalid).any()
    ov = jnp.where(pvalid, ov, 0)
    shifted = ov + shift
    return np.asarray(jnp.where((shifted > 127) | (shifted < -127), 0, ov))


def _jax_decode(stored, qual, tables, L, nbq, comp=_jax_comp):
    """The JAX decode step after the quality decode: the expansion's one
    gather (or the first n_cap bases), the N restore and the revcomp,
    concatenated as its payload (repaq_tpu/codec/device_engine.py:984-1021);
    stored holds flat_cap bytes."""
    stored = jnp.asarray(stored)
    qual = jnp.asarray(qual)
    rows = qual.shape[0] // L
    n_cap = rows * L
    flat_cap = stored.shape[0]
    if tables is not None:
        i = jnp.arange(L, dtype=jnp.int32)[None, :]
        so, f, w, prev = (jnp.asarray(t)[:, None] for t in tables)
        src_odd = jnp.where(i < f, so - f + i,
                            jnp.where(i >= L - w, prev + i - (L - w),
                                      so + i - f))
        odd = (jnp.arange(rows) % 2 == 1)[:, None]
        src = jnp.where(odd, src_odd, so + i).reshape(-1)
        seq = stored[jnp.clip(src, 0, flat_cap - 1)]
    else:
        seq = stored[:n_cap]
    if nbq is not None:
        seq = jnp.where(qual == nbq, jnp.uint8(ord("N")), seq)
    odd = (jnp.arange(rows) % 2 == 1)[:, None]
    seq_mat = jnp.where(odd, comp(jnp.flip(seq.reshape(rows, L), axis=1)),
                        seq.reshape(rows, L))
    qual_mat = jnp.where(odd, jnp.flip(qual.reshape(rows, L), axis=1),
                         qual.reshape(rows, L))
    return np.concatenate([np.asarray(seq_mat).reshape(-1),
                           np.asarray(qual_mat).reshape(-1)])


def _acgtn(*arrays) -> bool:
    return all(np.isin(a, ACGTN).all() for a in arrays)


def test_comp_table_is_vectorized_comp_on_every_byte():
    """The complement the kernels write (kernels.comp_table, its numpy
    copy in chip_smoke) is codec/vectorized.py's _COMP, in the port and in
    the JAX package, on all 256 byte values; on ACGTN it is also the JAX
    steps' ACGT-only complement."""
    got = TK.comp_table("cpu").numpy()
    assert np.array_equal(got, vectorized._COMP)
    assert np.array_equal(got, jax_vectorized._COMP)
    assert np.array_equal(got, comp_np())
    assert np.array_equal(got[ACGTN], np.asarray(_jax_comp(jnp.asarray(ACGTN))))
    assert (got[np.setdiff1d(np.arange(256), np.frombuffer(
        b"AaCcGgTt", np.uint8))] == ord("N")).all()


@pytest.mark.parametrize("name", PAIR_CASES)
def test_pe_encode_pairs_matches_jax_step(name):
    """On each chip_smoke PAIR_CASES grid (pad rows, odd pair counts,
    clamps at +-127, whole-row overlaps, L of 11-13, 37, 1000 and 5000, no
    search, every byte value): the rows transformed in place as the JAX
    step transforms them (on ACGTN; every byte by vectorized._COMP), and
    ov equal to JAX's search with the step's mask and clamp, and to the
    reference's scalar search on the valid pairs."""
    seq, qual, n, shift, search, _nbq = pair_case(name)
    s, q = _t(seq.copy()), _t(qual.copy())
    before = dict(TK.launches)
    ov = TK.pe_encode_pairs(s, q, n, shift, search)
    assert TK.launches == before  # CPU tensors launch nothing
    assert ov.dtype == torch.int32 and ov.shape == (seq.shape[0] // 2,)
    tseq, tqual = (np.asarray(a) for a in _jax_transform(
        jnp.asarray(seq), jnp.asarray(qual)))
    assert np.array_equal(q.numpy(), tqual)
    if _acgtn(seq):
        assert np.array_equal(s.numpy(), tseq)
    else:
        want = seq.copy()
        want[1::2] = comp_np()[seq[1::2, ::-1]]
        assert np.array_equal(s.numpy(), want)
    # the search and clamp on the port's rows (on ACGTN the JAX step's)
    assert np.array_equal(ov.numpy(), _jax_ov(s.numpy(), n, shift, search))
    if search:
        ref = np.array([oracle.overlap(a.tobytes(), b.tobytes()) for a, b in
                        zip(s.numpy()[0:2 * n:2], s.numpy()[1:2 * n:2])])
        ref[(ref + shift > 127) | (ref + shift < -127)] = 0
        assert np.array_equal(ov.numpy()[:n], ref)
        assert not ov.numpy()[n:].any()
    else:
        assert not ov.numpy().any()


def test_pair_cases_reach_their_edges():
    """The cases plant what they name: overlaps kept at ov + shift = +-127
    and cut at +-128, whole-row overlaps, o = 12 both ways, pad rows and
    pairs past the reads at 0."""
    found = {}
    for name in ("clamp_plus10", "clamp_minus24", "whole_rows", "pad_rows"):
        seq, qual, n, shift, search, _ = pair_case(name)
        s, q = _t(seq.copy()), _t(qual.copy())
        found[name] = (TK.pe_encode_pairs(s, q, n, shift, search).numpy(),
                       n, shift)
    ov, _n, shift = found["clamp_plus10"]
    assert {117, -137} <= set(ov.tolist())
    assert not ({118, -138, 150} & set(ov.tolist()))
    ov, _n, shift = found["clamp_minus24"]
    assert {-103, 150} <= set(ov.tolist()) and -104 not in ov.tolist()
    # a whole row planted backward is a whole row forward too, found first
    ov, _n, _s = found["whole_rows"]
    assert {40, 12, -12} <= set(ov.tolist()) and -40 not in ov.tolist()
    ov, n, _s = found["pad_rows"]
    assert (ov[:n] != 0).any() and not ov[n:].any()


@pytest.mark.parametrize("name", [c for c in OVERLAP_CASES
                                  if overlap_case(c)[0].shape[1]
                                  == overlap_case(c)[1].shape[1]])
def test_pe_encode_pairs_on_overlap_cases(name):
    """chip_smoke's OVERLAP_CASES of equal row lengths as PE grids (r1
    even, r2's untransformed row odd): the search on the transformed rows
    is the reference's, the clamp at the header's shift of -24; on ACGTN
    rows the JAX step's."""
    r1, r2 = overlap_case(name)
    grid = np.empty((2 * r1.shape[0], r1.shape[1]), np.uint8)
    grid[0::2] = r1
    grid[1::2] = comp_np()[r2[:, ::-1]]
    qual = np.full(grid.shape, ord("F"), np.uint8)
    s, q = _t(grid.copy()), _t(qual)
    ov = TK.pe_encode_pairs(s, q, r1.shape[0], -24, True).numpy()
    tr = s.numpy()
    ref = np.array([oracle.overlap(a.tobytes(), b.tobytes())
                    for a, b in zip(tr[0::2], tr[1::2])])
    ref[(ref - 24 > 127) | (ref - 24 < -127)] = 0
    assert np.array_equal(ov, ref)
    if _acgtn(r1, r2):
        assert np.array_equal(tr[1::2], r2)
        assert np.array_equal(ov, _jax_ov(tr, r1.shape[0], -24, True))


def test_pe_encode_pairs_on_the_pe_chunk_grid():
    """The head of chip_smoke's PE chunk grid (2,000 pairs of phase 5's
    reads), untransformed: the rows and ov equal the JAX step's, both
    directions found."""
    tgrid = pe_overlap_grid()[:4000]
    seq = tgrid.copy()
    seq[1::2] = comp_np()[tgrid[1::2, ::-1]]
    qual = np.random.default_rng(5).choice(np.frombuffer(b"F:,#", np.uint8),
                                           size=seq.shape)
    s, q = _t(seq.copy()), _t(qual.copy())
    ov = TK.pe_encode_pairs(s, q, 1990, -24, True).numpy()
    tseq, tqual = (np.asarray(a) for a in _jax_transform(
        jnp.asarray(seq), jnp.asarray(qual)))
    assert np.array_equal(s.numpy(), tseq) and np.array_equal(s.numpy(),
                                                              tgrid)
    assert np.array_equal(q.numpy(), tqual)
    assert np.array_equal(ov, _jax_ov(tseq, 1990, -24, True))
    assert (ov > 0).any() and (ov < 0).any() and not ov[1990:].any()


def _decode_args(name, nbq_override=False):
    """(stored, qual, tables, L, nbq, seq, qual, n) of a PAIR_CASES grid
    encoded by the plain version, as DeviceEngine's decode gets it."""
    seq, qual, n, shift, search, nbq = pair_case(name)
    s, q = _t(seq.copy()), _t(qual.copy())
    ov = TK.pe_encode_pairs(s, q, n, shift, search).numpy()
    stored, qflat, tab = decode_inputs(s.numpy(), q.numpy(), ov, n, search,
                                       nbq)
    if nbq_override:
        nbq = ord(":")
    return stored, qflat, tab, seq.shape[1], nbq, seq, qual, n


@pytest.mark.parametrize("name", PAIR_CASES)
@pytest.mark.parametrize("nbq_colon", [False, True])
def test_pe_decode_rows_matches_jax_step(name, nbq_colon):
    """Each PAIR_CASES grid encoded and decoded: pe_decode_rows' payload
    equals the JAX decode step's expansion, N restore and revcomp (on
    ACGTN; every byte by vectorized._COMP), with the case's nbq or ':',
    tables or none (no search); without an override the reads come back
    (but for every byte value, whose complement is not its own inverse)."""
    stored, qflat, tab, L, nbq, seq, qual, n = _decode_args(name, nbq_colon)
    got = TK.pe_decode_rows(_t(stored), _t(qflat),
                            None if tab is None else _t(tab), L, nbq)
    assert got.dtype == torch.uint8 and got.shape == (2 * qflat.shape[0],)
    acgtn = _acgtn(stored)
    comp = _jax_comp if acgtn else (lambda x: jnp.asarray(comp_np())[x])
    want = _jax_decode(stored, qflat, tab, L, nbq, comp)
    assert np.array_equal(got.numpy(), want)
    if not nbq_colon and name != "bytes_all":
        b = 2 * n * L
        assert np.array_equal(got.numpy()[:b], seq[:2 * n].reshape(-1))
        assert np.array_equal(got.numpy()[seq.size:seq.size + b],
                              qual[:2 * n].reshape(-1))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_pe_decode_rows_on_wild_tables(seed):
    """Tables of no real chunk (offsets anywhere in int32 or past the
    stored ends): the int32 arithmetic wraps and the index clamps as in
    the JAX step."""
    stored, qflat, _tab, L, nbq, _s, _q, _n = _decode_args("pad_rows")
    rows = qflat.shape[0] // L
    tab = wild_tables(rows, L, stored.shape[0], seed=seed)
    got = TK.pe_decode_rows(_t(stored), _t(qflat), _t(tab), L, ord(","))
    assert np.array_equal(got.numpy(), _jax_decode(stored, qflat, tab, L,
                                                   ord(",")))


def _recorded(block, header, monkeypatch):
    """(encode args, decode args, chunk) of the pair kernels' calls when
    the port's engine encodes and decodes block on the CPU, the grids
    cloned before the in-place encode; the chunk's bytes are the host
    engine's."""
    calls = {"pe_encode_pairs": [], "pe_decode_rows": []}
    for name in calls:
        fn = getattr(TK, name)

        def spy(*args, _fn=fn, _name=name):
            calls[_name].append(tuple(a.clone() if isinstance(
                a, torch.Tensor) else a for a in args))
            return _fn(*args)
        monkeypatch.setattr(TK, name, spy)
    eng = TE.DeviceEngine("cpu", min_bases=0)
    chunk = eng.encode_chunk(header, block, True)
    assert chunk.to_bytes() == vectorized.encode_chunk(header, block,
                                                       True).to_bytes()
    back = eng.decode_chunk(header, chunk)
    assert np.array_equal(back.seq_flat, block.seq_flat)
    assert eng.stats["device_chunks"] == eng.stats["device_decodes"] == 1
    assert [len(v) for v in calls.values()] == [1, 1]
    return calls["pe_encode_pairs"][0], calls["pe_decode_rows"][0], chunk


@pytest.mark.parametrize("kind", ["overlap", "flagless", "nbasequal",
                                  "pad_rows"])
def test_pair_kernels_at_real_chunks_match_jax(kind, monkeypatch):
    """The pair kernels' calls recorded from real chunks through the
    port's engine on the CPU (a header with the overlap flag, one without
    it, the nBaseQual N policy, a chunk whose b_cap pads 88 rows): the
    encode's rows and ov equal the JAX step's, and the decode's payload
    (tables from the encoded chunk, or none) the JAX decode step's; its
    rows of real reads equal the reads that the JAX package's device
    engine decodes from the same chunk."""
    from repaq_tpu_torch.constants import BIT_ENCODE_PE_BY_OVERLAP

    n, L = (296, 150) if kind == "pad_rows" else (600, 96)
    block = _mk_block(n, L, seed=31, pe_overlap=0.6,
                      nfrac=0.02 if kind == "nbasequal" else 0.01)
    if kind == "nbasequal":
        qual = block.qual_flat
        qual[qual == ord("#")] = ord(",")
        qual[block.seq_flat == ord("N")] = ord("#")
    header = vectorized.make_header_pe(block)
    if kind == "flagless":
        header.flags &= ~BIT_ENCODE_PE_BY_OVERLAP
    enc, dec, chunk = _recorded(block, header, monkeypatch)
    seq_mat, qual_mat, n_pairs, shift, search = enc
    assert search == (kind != "flagless")
    s, q = seq_mat.clone(), qual_mat.clone()
    ov = TK.pe_encode_pairs(s, q, n_pairs, shift, search).numpy()
    tseq, tqual = (np.asarray(a) for a in _jax_transform(
        jnp.asarray(seq_mat.numpy()), jnp.asarray(qual_mat.numpy())))
    assert np.array_equal(s.numpy(), tseq) and np.array_equal(q.numpy(),
                                                              tqual)
    assert np.array_equal(ov, _jax_ov(tseq, n_pairs, shift, search))
    if search:
        assert (ov > 0).any()
    stored, qflat, tables, L_, nbq = dec
    assert L_ == L and (tables is None) == (kind == "flagless")
    assert (nbq is not None) == (kind == "nbasequal")
    got = TK.pe_decode_rows(stored, qflat, tables, L, nbq).numpy()
    assert np.array_equal(got, _jax_decode(
        stored.numpy(), qflat.numpy(),
        None if tables is None else tables.numpy(), L, nbq))
    jax_eng = JaxEngine(min_bases=0)
    back = jax_eng.decode_chunk(header, chunk)
    assert jax_eng.stats["device_decodes"] == 1
    real = n * L
    assert np.array_equal(got[:real], back.seq_flat)
    assert np.array_equal(got[qflat.shape[0]:qflat.shape[0] + real],
                          back.qual_flat)


def test_parent_compositions_match_the_kernels_plain_versions():
    """chip_smoke's parent compositions (timed beside the kernels in
    turns on the card) compute what the plain versions compute."""
    for name in ("pad_rows", "nbq", "no_search", "not16"):
        seq, qual, n, shift, search, nbq = pair_case(name)
        ov, ts, tq = parent_pe_encode(_t(seq), _t(qual), n, shift, search)()
        s, q = _t(seq.copy()), _t(qual.copy())
        assert torch.equal(ov, TK.pe_encode_pairs(s, q, n, shift, search))
        assert torch.equal(ts, s) and torch.equal(tq, q)
        stored, qflat, tab, L, nbq, *_ = _decode_args(name)
        args = (_t(stored), _t(qflat), None if tab is None else _t(tab), L,
                nbq)
        want = TK.pe_decode_rows(*args)
        assert torch.equal(parent_pe_decode(args[0].clone(), args[1].clone(),
                                            args[2], L, nbq)(), want)


def test_pair_bounds():
    """chip_smoke's byte bounds: the encode's grid read, its odd qual rows
    read, its odd rows written and ov; the decode's stored bytes some row
    reads (each once), the quality grid and tables read, the payload."""
    assert pairs_moved(98304, 150) == (98304 * 150 + 49152 * 150
                                       + 98304 * 150 + 4 * 49152)
    stored, qflat, tab, L, nbq, _s, _q, n = _decode_args("pad_rows")
    rows = qflat.shape[0] // L
    stored_read = int(tab[0, 2 * n - 1]) + L - int(np.abs(
        tab[1, 2 * n - 1]) + np.abs(tab[2, 2 * n - 1]))
    assert rows_moved(_t(stored), _t(qflat), _t(tab), L) == (
        stored_read + qflat.size + 16 * rows + 2 * qflat.size)
    assert rows_moved(_t(stored), _t(qflat), None, L) == 4 * qflat.size


def test_pair_kernels_check_their_arguments():
    """Inputs the kernels do not take raise, on the CPU as on a card."""
    g = torch.zeros((8, 30), dtype=torch.uint8)
    for bad in ((g.int(), g), (g[:7], g[:7]), (g, g[:, :29]), (g[:, ::2],
                                                               g[:, ::2])):
        with pytest.raises(ValueError):
            TK.pe_encode_pairs(*bad, 4, 0, True)
    flat = torch.zeros(240, dtype=torch.uint8)
    tab = torch.zeros((4, 8), dtype=torch.int32)
    for args in ((flat, flat[:210], tab, 30, None),  # 7 rows
                 (flat, flat, tab[:, :7], 30, None),
                 (flat, flat, tab.long(), 30, None),
                 (flat, flat, tab, 30, 256),
                 (flat[:0], flat, tab, 30, None),
                 (flat.view(8, 30), flat, tab, 30, None)):
        with pytest.raises(ValueError):
            TK.pe_decode_rows(*args)
    with pytest.raises(ValueError):
        TK.pe_decode_rows(flat, flat, tab, 30, None,
                          torch.zeros(479, dtype=torch.uint8))
    out = torch.zeros(480, dtype=torch.uint8)
    assert TK.pe_decode_rows(flat, flat, tab, 30, None, out) is out


def test_engine_pe_steps_have_no_torch_pair_work_left():
    """The PE steps reach the pair work through the two kernels alone:
    device_engine.py calls pe_encode_pairs and pe_decode_rows once each
    and no longer flips rows, gathers by a complement table or expands by
    an index grid; overlap_pairs is left to the tests."""
    src = (REPO / "repaq_tpu_torch" / "codec" / "device_engine.py").read_text()
    calls = [n.func.attr for n in ast.walk(ast.parse(src))
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)]
    assert calls.count("pe_encode_pairs") == 1
    assert calls.count("pe_decode_rows") == 1
    assert "flip" not in calls and "overlap_pairs_device" not in calls
    assert "_expand" not in src and "_comp" not in src


# ---------------------------------------------------------------------------
# numpy models of csrc/overlap.cu's word arithmetic (the kernels run only
# on a card; tests/test_torch_cuda.py holds them to the plain versions)
# ---------------------------------------------------------------------------

_ACTG = 0x47544341


def _zero_bytes(x):
    hi = ~(((x & 0x7F7F7F7F) + 0x7F7F7F7F) | x | 0x7F7F7F7F) & 0xFFFFFFFF
    return ((hi >> 7) * 0xFF) & 0xFFFFFFFF


def _byte_perm(x, sel):
    b = x.to_bytes(4, "little")
    return int.from_bytes(bytes(b[(sel >> (4 * k)) & 7] if (sel >> (4 * k))
                                & 7 < 4 else 0 for k in range(4)),
                          "little")


def _comp4(x):
    u = x & 0xDFDFDFDF
    code = (u >> 1) & 0x03030303
    c2 = code | (code >> 4)
    sel = (c2 & 0xFF) | ((c2 >> 8) & 0xFF00)
    ok = _zero_bytes(_byte_perm(_ACTG, sel) ^ u)
    return ((_byte_perm(_ACTG, sel ^ 0x2222) & ok)
            | (0x4E4E4E4E & ~ok)) & 0xFFFFFFFF


def _rev4(x):
    return int.from_bytes(x.to_bytes(4, "little")[::-1], "little")


def _word_at(buf, p):
    return int.from_bytes(bytes(buf[p:p + 4]), "little")


def _row_of(e, L):
    return (e * (((1 << 40) + L - 1) // L)) >> 40


def test_word_complement_model_is_the_comp_table():
    """comp4 (four complements at once by byte permutes of "ACTG" and a
    zero-byte test) gives comp_table's byte for every byte value in every
    byte of a word, next to every other kind of byte."""
    comp = TK.comp_table("cpu").numpy()
    rng = np.random.default_rng(4)
    for v in range(256):
        for lane in range(4):
            others = rng.integers(0, 256, size=4)
            others[lane] = v
            x = int.from_bytes(bytes(others.astype(np.uint8)), "little")
            got = _comp4(x).to_bytes(4, "little")
            assert list(got) == [int(comp[b]) for b in others]
    assert _rev4(0x04030201) == 0x01020304
    for e in range(0, 1 << 18, 997):
        for L in (1, 11, 37, 150, 5000, 20000, 65535):
            if e * L < 1 << 40:
                assert _row_of(e, L) == e // L


def _encode_tile_model(seq, qual, o):
    """pe_encode_kernel's tile build over a whole (rows, L) grid as one
    tile staged at byte o, as encode_tile makes it: every aligned output
    word inside a row as a word, a word across two rows from the last four
    bytes of the one and the first four of the next, the tile's end words
    (and rows under 4 bytes) a byte at a time."""
    rows, L = seq.shape
    n = rows * L
    s = np.zeros(o + n + 8, np.uint8)
    q = np.zeros_like(s)
    s[o:o + n], q[o:o + n] = seq.reshape(-1), qual.reshape(-1)
    os_, oq = np.zeros_like(s), np.zeros_like(s)
    comp = comp_np()

    def word(j, k):
        r = o + j * L
        if j & 1:
            p = r + L - 4 - k
            return _comp4(_rev4(_word_at(s, p))), _rev4(_word_at(q, p))
        return _word_at(s, r + k), _word_at(q, r + k)

    for w in range(o >> 2, (o + n + 3) >> 2):
        t = 4 * w
        e = t - o
        if e >= 0 and e + 4 <= n and L >= 4:
            j = _row_of(e, L)
            k = e - j * L
            if k <= L - 4:
                c, qw = word(j, k)
            else:
                m = L - k
                (c, qw), (c1, q1) = word(j, L - 4), word(j + 1, 0)
                c = ((c >> (32 - 8 * m)) | (c1 << (8 * m))) & 0xFFFFFFFF
                qw = ((qw >> (32 - 8 * m)) | (q1 << (8 * m))) & 0xFFFFFFFF
            os_[t:t + 4] = np.frombuffer(c.to_bytes(4, "little"), np.uint8)
            oq[t:t + 4] = np.frombuffer(qw.to_bytes(4, "little"), np.uint8)
            continue
        for b in range(max(e, 0), min(e + 4, n)):
            jb = _row_of(b, L)
            kb = b - jb * L
            src = o + jb * L + L - 1 - kb if jb & 1 else o + b
            os_[o + b] = comp[s[src]] if jb & 1 else s[src]
            oq[o + b] = q[src]
    return (os_[o:o + n].reshape(rows, L), oq[o:o + n].reshape(rows, L))


@pytest.mark.parametrize("name", ["pad_rows", "l37", "l13", "l11",
                                  "bytes_all", "not16"])
@pytest.mark.parametrize("o", [0, 1, 6, 15])
def test_encode_tile_model_matches_the_plain_transform(name, o):
    """The encode's word/byte split (rows straddling words, L not a
    multiple of 4, tiles at every offset mod 16) gives the plain version's
    rows."""
    seq, qual, n, shift, search, _nbq = pair_case(name)
    s, q = _t(seq.copy()), _t(qual.copy())
    TK.pe_encode_pairs(s, q, n, shift, search)
    got = _encode_tile_model(seq, qual, o)
    assert np.array_equal(got[0], s.numpy()) and np.array_equal(got[1],
                                                                q.numpy())


def _decode_tile_model(stored, qual, tab, L, nbq, r0, nrows, ooff):
    """pe_decode_kernel's build of the tile of rows [r0, r0 + nrows): its
    stored range staged from its first row's offset, each row's spans
    (row_spans), then every aligned output word inside a row of real spans
    as a word, across two rows from the last four bytes of the one and the
    first four of the next, the rest by source_of's byte path."""
    n_stored = stored.shape[0]
    rows = qual.shape[0] // L
    first = int(tab[0, r0]) if tab is not None else r0 * L
    lo = min(max(first, 0), n_stored)
    hi = min(lo + nrows * L, n_stored)
    soff, qoff = lo & 15, (r0 * L) & 15
    sb = np.zeros(soff + nrows * L + 24, np.uint8)
    sb[soff:soff + hi - lo] = stored[lo:hi]
    qb = np.zeros(qoff + nrows * L + 24, np.uint8)
    qb[qoff:qoff + nrows * L] = qual[r0 * L:(r0 + nrows) * L]
    nb = nrows * L
    os_ = np.zeros(ooff + nb + 8, np.uint8)
    oq = np.zeros_like(os_)
    comp = comp_np()

    def table(j):
        if tab is None:
            return (r0 + j) * L, 0, 0, 0
        return tuple(int(tab[c, r0 + j]) for c in range(4))

    def spans(j):
        so, f, w, prev = table(j)
        odd = j & 1
        a = so - f if odd else so
        la = L - w if odd else L
        fast = ((not odd or (0 <= f <= L and 0 <= w <= L
                             and (f == 0 or w == 0)))
                and (la == 0 or (a >= lo and a + la <= hi))
                and (not odd or w == 0 or (prev >= lo and prev + w <= hi)))
        return (soff + a - lo, la, soff + prev - lo) if fast else None

    def wrap(v):
        return (v + 2**31) % 2**32 - 2**31

    def one(e):
        j = _row_of(e, L)
        kk = e - j * L
        odd = j & 1
        i = L - 1 - kk if odd else kk
        so, f, w, prev = table(j)
        lw = wrap(L - w)
        if not odd:
            src = wrap(so + i)
        elif i < f:
            src = wrap(so - f + i)
        elif i >= lw:
            src = wrap(prev + i - lw)
        else:
            src = wrap(so + i - f)
        src = min(max(src, 0), n_stored - 1)
        c = sb[soff + src - lo] if lo <= src < hi else stored[src]
        qc = qb[qoff + j * L + i]
        if nbq is not None and qc == nbq:
            c = ord("N")
        os_[ooff + e] = comp[c] if odd else c
        oq[ooff + e] = qc

    rec = [spans(j) for j in range(nrows)]
    nbq_i = -1 if nbq is None else nbq

    def restore(c, qw):
        if nbq_i < 0:
            return c
        m = _zero_bytes(qw ^ (0x01010101 * nbq_i))
        return (c & ~m & 0xFFFFFFFF) | (0x4E4E4E4E & m)

    def word(j, k):
        r = rec[j]
        if r is None:
            return None
        qrow = qoff + j * L
        if not j & 1:
            qw = _word_at(qb, qrow + k)
            return restore(_word_at(sb, r[0] + k), qw), qw
        i = L - 4 - k
        if i + 3 < r[1]:
            x = _word_at(sb, r[0] + i)
        elif i >= r[1]:
            x = _word_at(sb, r[2] + i - r[1])
        else:
            return None
        y = _word_at(qb, qrow + i)
        return _comp4(_rev4(restore(x, y))), _rev4(y)

    for wi in range(ooff >> 2, (ooff + nb + 3) >> 2):
        t = 4 * wi
        e = t - ooff
        got = None
        if e >= 0 and e + 4 <= nb and L >= 4:
            j = _row_of(e, L)
            kk = e - j * L
            if kk <= L - 4:
                got = word(j, kk)
            else:
                m = L - kk
                a, b = word(j, L - 4), word(j + 1, 0)
                if a is not None and b is not None:
                    got = tuple(((x >> (32 - 8 * m)) | (y << (8 * m)))
                                & 0xFFFFFFFF for x, y in zip(a, b))
        if got is None:
            for x in range(max(e, 0), min(e + 4, nb)):
                one(x)
            continue
        os_[t:t + 4] = np.frombuffer(got[0].to_bytes(4, "little"), np.uint8)
        oq[t:t + 4] = np.frombuffer(got[1].to_bytes(4, "little"), np.uint8)
    return os_[ooff:ooff + nb], oq[ooff:ooff + nb]


@pytest.mark.parametrize("name,wild", [("pad_rows", False), ("l37", False),
                                       ("straddle", False), ("nbq", False),
                                       ("no_search", False),
                                       ("whole_rows", False),
                                       ("pad_rows", True)])
@pytest.mark.parametrize("tile,ooff", [(32, 0), (8, 5), (5, 11)])
def test_decode_tile_model_matches_the_plain_version(name, wild, tile, ooff):
    """The decode's tiles (a stored range from each tile's first row, spans
    a row, words inside rows of real spans, the byte path elsewhere: pad
    rows, spans across a word, wild tables) give the plain version's
    payload, tile by tile, at output offsets off 16 bytes."""
    stored, qflat, tab, L, nbq, *_ = _decode_args(name)
    if wild:
        tab = wild_tables(qflat.shape[0] // L, L, stored.shape[0])
    want = TK.pe_decode_rows(_t(stored), _t(qflat),
                             None if tab is None else _t(tab), L,
                             nbq).numpy()
    rows = qflat.shape[0] // L
    n = rows * L
    for r0 in range(0, rows, 2 * tile):
        nrows = min(2 * tile, rows - r0)
        os_, oq = _decode_tile_model(stored, qflat, tab, L, nbq, r0, nrows,
                                     ooff)
        assert np.array_equal(os_, want[r0 * L:(r0 + nrows) * L])
        assert np.array_equal(oq, want[n + r0 * L:n + (r0 + nrows) * L])


def _decode_piece_model(stored, qual, tab, L, nbq, piece):
    """pe_decode_direct_kernel's work (the decode's route for rows too
    long for a tile) as its warps do it: the items (row, piece)
    in turn, each piece of up to `piece` bytes of a row moved a byte a
    lane, 32 lanes a step: the source by source_of's int32 arithmetic
    (wrapping alike) clamped to the stored bytes, 'N' where the quality is
    nbq, an odd row's byte written at L - 1 - i and complemented."""
    n_stored = stored.shape[0]
    rows = qual.shape[0] // L
    n = rows * L
    out = np.zeros(2 * n, np.uint8)
    comp = comp_np()
    pieces = -(-L // piece)

    def wrap(v):
        return (v + 2**31) % 2**32 - 2**31

    for it in range(rows * pieces):
        r = it // pieces
        i0 = (it - r * pieces) * piece
        i1 = min(L, i0 + piece)
        odd = r & 1
        if tab is None:
            so, f, w, prev = wrap(r * L), 0, 0, 0
        else:
            so, f, w, prev = (int(tab[c, r]) for c in range(4))
        lw = wrap(L - w)
        for lane in range(32):
            for i in range(i0 + lane, i1, 32):
                if not odd:
                    src = wrap(so + i)
                elif i < f:
                    src = wrap(so - f + i)
                elif i >= lw:
                    src = wrap(prev + i - lw)
                else:
                    src = wrap(so + i - f)
                c = stored[min(max(src, 0), n_stored - 1)]
                qc = qual[r * L + i]
                if nbq is not None and qc == nbq:
                    c = ord("N")
                at = r * L + (L - 1 - i if odd else i)
                out[at] = comp[c] if odd else c
                out[n + at] = qc
    return out


@pytest.mark.parametrize("name,wild", [("pad_rows", False), ("l37", False),
                                       ("straddle", False), ("nbq", False),
                                       ("no_search", False),
                                       ("whole_rows", False),
                                       ("pad_rows", True)])
@pytest.mark.parametrize("piece", [256, 32, 7])
def test_decode_piece_model_matches_the_plain_version(name, wild, piece):
    """The direct route's pieces (a row in one piece at 256 bytes, in pieces of
    one step of lanes at 32, in pieces that split words and lanes at 7:
    pad rows, spans across pieces, wild tables) give the plain version's
    payload."""
    stored, qflat, tab, L, nbq, *_ = _decode_args(name)
    if wild:
        tab = wild_tables(qflat.shape[0] // L, L, stored.shape[0])
    want = TK.pe_decode_rows(_t(stored), _t(qflat),
                             None if tab is None else _t(tab), L,
                             nbq).numpy()
    got = _decode_piece_model(stored, qflat, tab, L, nbq, piece)
    assert np.array_equal(got, want)
