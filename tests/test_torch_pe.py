"""The port's paired-end interleaved path against the JAX package and the
host engine, on the CPU: the byte-form frontend and the pack-only kernel
(plain versions here; the CUDA kernels are held against them in
tests/test_torch_cuda.py), the overlap search, the PE encode streams, and
the engine's PE encode and decode through DeviceEngine and the CLI.

Inputs are made with numpy from seeds and given to both packages; the
Pallas entries run in interpret mode, as tests/test_pallas.py runs them.
Everything is integer: the tolerance is exact equality."""

import gzip
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repaq_tpu.codec import kernels_np as K
from repaq_tpu.codec import oracle
from repaq_tpu.codec import vectorized
from repaq_tpu.codec.device_engine import DeviceEngine as JaxEngine
from repaq_tpu.constants import BIT_ENCODE_PE_BY_OVERLAP
from repaq_tpu.ops import device_streams as D
from repaq_tpu.ops import pallas_tpu as PT
from repaq_tpu_torch import cli
from repaq_tpu_torch.codec import device_engine as TE
from repaq_tpu_torch.ops import device_streams as T
from repaq_tpu_torch.ops import kernels as TK

from chip_smoke import OVERLAP_CASES, overlap_case, pe_overlap_grid
from test_device_engine import _mk_block
from test_torch_cuda import _frontend_case
from test_torch_reference import jax_native  # noqa: F401

# repaq_tpu's native code runs from its source built for this CPU
pytestmark = pytest.mark.usefixtures("jax_native")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FX = os.path.join(REPO, "tests", "fixtures")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# kernels: B1' (byte-form frontend) and B4 (pack only)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1000, 4099, 16384 + 12])
def test_frontend_bytes_matches_pallas(n):
    seq, qual, table, major = _frontend_case(n, n, 0.02, True)
    got = TK.encode_frontend_bytes(_t(seq), _t(qual), _t(table), major)
    want = PT.encode_frontend_pallas(jnp.asarray(seq), jnp.asarray(qual),
                                     jnp.asarray(table), major)
    assert [g.dtype for g in got] == [torch.uint8, torch.bool, torch.int32]
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert np.array_equal(got[0].numpy(), K.pack_2bit(seq))
    assert int((got[2] == len(table)).sum()) == int((qual == 99).sum())


@pytest.mark.parametrize("n", [1, 5, 1023, 4099])
def test_pack_bases_matches_pallas_and_host(n):
    rng = np.random.default_rng(n)
    seq = rng.choice(np.frombuffer(b"GATCN", np.uint8), size=n)
    got = TK.pack_bases(_t(seq)).numpy()
    assert np.array_equal(got, np.asarray(PT.pack_bases_pallas(seq)))
    assert np.array_equal(got, K.pack_2bit(seq))


# ---------------------------------------------------------------------------
# overlap search
# ---------------------------------------------------------------------------


def _overlap_case(p, L1, L2, seed):
    """Pairs with planted forward overlaps (r1 suffix = r2 prefix),
    backward ones (r2 suffix = r1 prefix), none, and low-complexity rows
    whose first match is the shortest allowed."""
    rng = np.random.default_rng(seed)
    r1 = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(p, L1))
    r2 = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(p, L2))
    minlen = min(L1, L2)
    for i in range(p):
        kind = i % 4
        o = int(rng.integers(1, minlen + 1))
        if kind == 0:
            r2[i, :o] = r1[i, L1 - o:]
        elif kind == 1:
            r1[i, :o] = r2[i, L2 - o:]
        elif kind == 2 and i % 8 == 2:
            r1[i] = ord("A")
            r2[i] = ord("A")
    r1[rng.random((p, L1)) < 0.002] = ord("N")
    return r1, r2


@pytest.mark.parametrize("L1,L2", [(96, 96), (100, 80), (70, 120), (10, 10),
                                   (11, 40)])
def test_overlap_pairs_matches_jax_and_host(L1, L2):
    r1, r2 = _overlap_case(400, L1, L2, L1 * 1000 + L2)
    ov = T.overlap_pairs_device(_t(r1), _t(r2))
    wov, wcoll = jax.jit(D.overlap_pairs_device)(jnp.asarray(r1),
                                                 jnp.asarray(r2))
    assert ov.dtype == torch.int32 and ov.shape == (400,)
    assert not np.asarray(wcoll).any()
    assert np.array_equal(ov.numpy(), np.asarray(wov))
    assert np.array_equal(ov.numpy(), vectorized._overlap_pairs(r1, r2))
    assert np.array_equal(ov.numpy(), [oracle.overlap(a.tobytes(),
                                                      b.tobytes())
                                       for a, b in zip(r1, r2)])
    if min(L1, L2) >= 12:  # both kinds are found, and the shortest ones
        ov = ov.numpy()
        assert (ov > 0).any() and (ov < 0).any() and (ov == 12).any()
    else:
        assert not ov.numpy().any()


@pytest.mark.parametrize("name", OVERLAP_CASES)
def test_overlap_edge_cases_match_oracle_and_jax(name):
    """chip_smoke's edge cases of the overlap kernel (phase 2 holds the
    kernel to the plain version on them): the plain version and
    overlap_pairs_device against the reference's scalar search and JAX's
    hash search, as given and as strided views."""
    r1, r2 = overlap_case(name)
    want = np.array([oracle.overlap(a.tobytes(), b.tobytes())
                     for a, b in zip(r1, r2)], dtype=np.int32)
    wov, wcoll = jax.jit(D.overlap_pairs_device)(jnp.asarray(r1),
                                                 jnp.asarray(r2))
    assert not np.asarray(wcoll).any()
    assert np.array_equal(np.asarray(wov), want)
    assert np.array_equal(TK.overlap_pairs_plain(_t(r1), _t(r2)).numpy(),
                          want)
    wide = np.zeros((r1.shape[0], r1.shape[1] + r2.shape[1] + 3), np.uint8)
    wide[:, 1:1 + r1.shape[1]] = r1
    wide[:, 3 + r1.shape[1]:] = r2
    w = _t(wide)
    got = T.overlap_pairs_device(w[:, 1:1 + r1.shape[1]],
                                 w[:, 3 + r1.shape[1]:])
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def test_overlap_pairs_on_cpu_grid_and_bad_inputs():
    """The head of chip_smoke's PE chunk grid, read as the engine reads it
    (its odd and even rows): CPU tensors run the plain version and launch
    nothing; inputs that are not 2-D uint8 tensors of contiguous rows, one
    row count, raise, on the CPU as on a card."""
    grid = pe_overlap_grid()[:4000]
    g = _t(grid)
    want = np.array([oracle.overlap(a.tobytes(), b.tobytes())
                     for a, b in zip(grid[0::2], grid[1::2])], np.int32)
    before = dict(TK.launches)
    assert np.array_equal(TK.overlap_pairs(g[0::2], g[1::2]).numpy(), want)
    assert TK.overlap_pairs(g[:0], g[:0]).shape == (0,)
    assert TK.launches == before
    assert (want > 0).any() and (want < 0).any()
    for bad in ((g[0::2].int(), g[1::2]), (g[0], g[1]),
                (g[0::2], g[1::2][:-1]), (g[0::2, ::2], g[1::2, ::2])):
        with pytest.raises(ValueError):
            TK.overlap_pairs(*bad)


# ---------------------------------------------------------------------------
# PE encode streams
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("esc", [False, True])
def test_qualcol_encode_bid_form(esc):
    n = 16384
    seq, qual, table, major = _frontend_case(n, 31, 0.0, esc)
    _pk, _nm, bid = TK.encode_frontend_bytes(_t(seq), _t(qual), _t(table),
                                             major)
    n_esc = int((qual == 99).sum())
    esc_cap = 0 if n_esc == 0 else TE._bucket(n_esc, lo=8)
    nm_cap = TE._bucket(int((qual != major).sum()))
    out_size = 4 * len(table) + n + 8
    got, ln = T.qualcol_encode_device(None, _t(qual), len(table),
                                      esc_cap=esc_cap, nonmajor_cap=nm_cap,
                                      out_size=out_size, bid=bid)
    in_table = np.zeros(256, dtype=bool)
    in_table[table] = True
    in_table[major] = True
    want, wln = jax.jit(lambda q, tb, it, b: D.qualcol_encode_device(
        q, tb, major, it, esc_cap=esc_cap, bid=b, nonmajor_cap=nm_cap,
        out_size=out_size))(jnp.asarray(qual), jnp.asarray(table),
                            jnp.asarray(in_table), jnp.asarray(bid.numpy()))
    assert int(ln) == int(wln)
    assert np.array_equal(got.numpy(), np.asarray(want))
    host = K.encode_qual_by_col(qual, table, major)
    assert bytes(got.numpy()[: int(ln)]) == host.tobytes()
    # the meta form gives the same stream
    meta = bid.to(torch.uint8)
    got2, _ = T.qualcol_encode_device(meta, _t(qual), len(table),
                                      esc_cap=esc_cap, nonmajor_cap=nm_cap,
                                      out_size=out_size)
    assert torch.equal(got, got2)


@pytest.mark.parametrize("n,n_frac,pos_cap", [
    (16384, 0.001, 64),       # sparse: 4-byte word compaction
    (16384, 0.02, 512),       # sparse, many words
    (16384, 0.3, 16384),      # dense
    (4099, 0.01, 64),         # n % 4 != 0: dense
])
def test_positions_from_mask(n, n_frac, pos_cap):
    rng = np.random.default_rng(n + pos_cap)
    mask = rng.random(n) < n_frac
    mask[-1] = True  # the last position
    assert int(mask.sum()) <= pos_cap
    out_size = TE._bucket(min(4 * pos_cap, pos_cap + n // 64) + 16, lo=64)
    got, ln = T.encode_positions_from_mask(_t(mask), out_size, pos_cap)
    want, wln = jax.jit(lambda m: D.encode_positions_from_mask(
        m, out_size, pos_cap=pos_cap))(jnp.asarray(mask))
    assert int(ln) == int(wln)
    assert np.array_equal(got.numpy(), np.asarray(want))
    host = K.encode_positions(np.flatnonzero(mask))
    assert bytes(got.numpy()[: int(ln)]) == host.tobytes()


# ---------------------------------------------------------------------------
# the engine: PE encode and decode
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_eng():
    return JaxEngine(min_bases=0)


@pytest.fixture
def eng():
    return TE.DeviceEngine("cpu", min_bases=0)


@pytest.fixture(params=["token", "slot"])
def qual_branch(request, monkeypatch):
    """Force one branch of qualcol_decode_device in the engine's decode
    and record the run_cap it was given."""
    orig = TE.DeviceEngine._decode_caps
    seen = []

    def caps(*args):
        c = orig(*args)
        if c is None:
            return c
        qb, nb, npc, (tok, pos, esc, _run) = c
        # a token count bounds the number of 4-token run groups
        return qb, nb, npc, (tok, pos, esc,
                             tok if request.param == "token" else None)

    decode = T.qualcol_decode_device

    def spy(*args, **kw):
        seen.append(kw["run_cap"])
        return decode(*args, **kw)

    monkeypatch.setattr(TE.DeviceEngine, "_decode_caps", staticmethod(caps))
    monkeypatch.setattr(T, "qualcol_decode_device", spy)
    return request.param, seen


def _check_decode(eng, header, block, chunk, qual_branch):
    branch, seen = qual_branch
    before = eng.stats["device_decodes"]
    back = eng.decode_chunk(header, chunk)
    assert eng.stats["device_decodes"] == before + 1
    assert seen and all((r is None) == (branch == "slot") for r in seen)
    want = vectorized.decode_chunk(header, chunk)
    for f in ("name_flat", "name_off", "seq_flat", "seq_off", "qual_flat",
              "strand_flat"):
        assert np.array_equal(getattr(back, f), getattr(want, f)), f
    assert np.array_equal(back.seq_flat, block.seq_flat)
    assert np.array_equal(back.qual_flat, block.qual_flat)


@pytest.mark.parametrize("illumina", [True, False])
@pytest.mark.parametrize("nfrac", [0.0, 0.01])
def test_pe_chunk_identical_to_jax_and_host(eng, jax_eng, qual_branch,
                                            illumina, nfrac):
    block = _mk_block(600, 96, seed=7, pe_overlap=0.5, nfrac=nfrac,
                      illumina=illumina)
    header = vectorized.make_header_pe(block)
    want = vectorized.encode_chunk(header, block, True).to_bytes()
    got = eng.encode_chunk(header, block, True)
    assert got.to_bytes() == want
    assert jax_eng.encode_chunk(header, block, True).to_bytes() == want
    assert eng.stats["device_chunks"] == 1
    # Illumina pairs interleave and carry overlaps; the others go flat
    if illumina:
        assert header.encode_pe_by_overlap()
        ov = np.frombuffer(got.overlap_buf, np.int8) - header.overlap_shift
        assert (ov > 0).sum() > 100
    _check_decode(eng, header, block, got, qual_branch)


def test_pe_escape_chunk(eng, jax_eng, qual_branch):
    """Quality chars outside the first chunk's palette, in odd (reversed)
    reads too."""
    header = vectorized.make_header_pe(_mk_block(600, 96, seed=8,
                                                 pe_overlap=0.5))
    block = _mk_block(600, 96, seed=9, pe_overlap=0.5, esc=True)
    qual = block.qual_flat.reshape(600, 96)
    qual[3, 5:9] = ord("!")
    want = vectorized.encode_chunk(header, block, True).to_bytes()
    got = eng.encode_chunk(header, block, True)
    assert got.to_bytes() == want
    assert jax_eng.encode_chunk(header, block, True).to_bytes() == want
    assert eng.stats["device_chunks"] == 1
    _check_decode(eng, header, block, got, qual_branch)


def test_pe_flagless_interleaved_chunk(eng, jax_eng, qual_branch):
    """Reference fault C2: an interleavable chunk whose header lacks the
    overlap flag. vectorized revcomps the odd reads without elision; the
    JAX engine sends the chunk to its flat step, which does not. The port
    takes its PE step with the overlap search off."""
    block = _mk_block(600, 96, seed=7, pe_overlap=0.5)
    header = vectorized.make_header_pe(block)
    header.flags &= ~BIT_ENCODE_PE_BY_OVERLAP
    want = vectorized.encode_chunk(header, block, True)
    assert vectorized.analyze_chunk(header, block, True).can_interleave
    got = eng.encode_chunk(header, block, True)
    assert got.to_bytes() == want.to_bytes()
    assert eng.stats["device_chunks"] == 1
    assert jax_eng.encode_chunk(header, block, True).to_bytes() != (
        want.to_bytes())
    _check_decode(eng, header, block, got, qual_branch)


def test_pe_nbasequal_policy(eng, jax_eng, qual_branch):
    """A PE chunk whose header restores 'N' from a unique quality (no
    N-position stream): the decode marks Ns before the odd reads turn
    back."""
    block = _mk_block(600, 96, seed=13, pe_overlap=0.5, nfrac=0.02)
    qual = block.qual_flat
    qual[qual == ord("#")] = ord(",")
    qual[block.seq_flat == ord("N")] = ord("#")
    header = vectorized.make_header_pe(block)
    assert not header.encode_n_pos() and header.n_base_qual == ord("#")
    want = vectorized.encode_chunk(header, block, True).to_bytes()
    got = eng.encode_chunk(header, block, True)
    assert got.to_bytes() == want
    assert jax_eng.encode_chunk(header, block, True).to_bytes() == want
    assert eng.stats["device_chunks"] == 1
    _check_decode(eng, header, block, got, qual_branch)


def _plant_backward(block, L, seed):
    """Plant backward overlaps (the reverse complement of R2 ends in R1's
    prefix) into a third of block's pairs, of 12 up to L bases; those above
    103 are clamped to 0 by the overlap shift of -24."""
    rng = np.random.default_rng(seed)
    comp = np.zeros(256, dtype=np.uint8)
    comp[np.frombuffer(b"ACGTN", np.uint8)] = np.frombuffer(b"TGCAN",
                                                            np.uint8)
    seqs = block.seq_flat.reshape(-1, L)
    for p in range(1, seqs.shape[0] // 2, 3):
        o = int(rng.integers(12, L + 1))
        r2rc = np.concatenate([rng.choice(np.frombuffer(b"ACGT", np.uint8),
                                          size=L - o), seqs[2 * p, :o]])
        seqs[2 * p + 1] = comp[r2rc][::-1]


@pytest.mark.parametrize("L,nfrac,seed", [(96, 0.0, 41), (150, 0.01, 42),
                                          (150, 0.0, 43)])
def test_pe_overlaps_both_ways_on_the_device(eng, jax_eng, L, nfrac, seed):
    """A PE chunk with planted forward and backward overlaps takes the
    device step (no host route is left for the search), and its bytes
    equal the host engine's and the JAX engine's; the stored overlaps are
    the reference's search, clamped by the shift."""
    block = _mk_block(600, L, seed=seed, pe_overlap=0.5, nfrac=nfrac)
    _plant_backward(block, L, seed)
    header = vectorized.make_header_pe(block)
    assert header.encode_pe_by_overlap()
    want = vectorized.encode_chunk(header, block, True).to_bytes()
    got = eng.encode_chunk(header, block, True)
    assert got.to_bytes() == want
    assert jax_eng.encode_chunk(header, block, True).to_bytes() == want
    assert eng.stats["device_chunks"] == 1 and eng.stats["host_chunks"] == 0
    seqs = block.seq_flat.reshape(-1, L)
    comp = np.zeros(256, dtype=np.uint8)
    comp[np.frombuffer(b"ACGTN", np.uint8)] = np.frombuffer(b"TGCAN",
                                                            np.uint8)
    ref = np.array([oracle.overlap(seqs[2 * p].tobytes(),
                                   comp[seqs[2 * p + 1][::-1]].tobytes())
                    for p in range(seqs.shape[0] // 2)])
    shift = header.overlap_shift
    ref[(ref + shift > 127) | (ref + shift < -127)] = 0
    ov = np.frombuffer(got.overlap_buf, np.int8).astype(np.int64) - shift
    assert np.array_equal(ov, ref)
    assert (ov > 0).sum() > 50 and (ov < 0).sum() > 20


def test_pe_qfetch_overflow_takes_the_host_route(eng, monkeypatch):
    monkeypatch.setattr(TE, "_qfetch", lambda *a: 64)
    block = _mk_block(600, 96, seed=7, pe_overlap=0.5)
    header = vectorized.make_header_pe(block)
    got = eng.encode_chunk(header, block, True)
    assert got.to_bytes() == vectorized.encode_chunk(header, block,
                                                     True).to_bytes()
    assert eng.stats["host_chunks"] == 1 and eng.stats["device_chunks"] == 0


def test_pe_size_window_and_corrupt_overlap_bytes():
    """A PE chunk past the window takes the host both ways; a container
    whose overlap bytes claim more bases than a read holds takes the host
    decode, and gives what the host engine gives."""
    block = _mk_block(600, 96, seed=7, pe_overlap=0.5)
    header = vectorized.make_header_pe(block)
    want = vectorized.encode_chunk(header, block, True)
    small = TE.DeviceEngine("cpu", min_bases=0, max_bases=600 * 96 - 1)
    assert small.encode_chunk(header, block, True).to_bytes() == (
        want.to_bytes())
    small.decode_chunk(header, want)
    assert small.stats == {"device_chunks": 0, "host_chunks": 1,
                           "device_decodes": 0, "host_decodes": 1}
    bad = vectorized.encode_chunk(header, block, True)
    ovb = bytearray(bad.overlap_buf)
    ovb[0] = (200 + header.overlap_shift) & 0xFF
    bad.overlap_buf = bytes(ovb)
    eng = TE.DeviceEngine("cpu", min_bases=0)
    got = eng.decode_chunk(header, bad)
    assert np.array_equal(got.seq_flat,
                          vectorized.decode_chunk(header, bad).seq_flat)
    assert eng.stats["host_decodes"] == 1


def test_pe_odd_rows_and_padding_stay_out(eng):
    """A chunk whose b_cap pads 88 rows: padded rows store nothing, and the
    overlap bytes of padded pairs never reach the container."""
    block = _mk_block(296, 150, seed=12, pe_overlap=0.9, nfrac=0.005)
    header = vectorized.make_header_pe(block)
    got = eng.encode_chunk(header, block, True)
    assert got.to_bytes() == vectorized.encode_chunk(header, block,
                                                     True).to_bytes()
    assert len(got.overlap_buf) == 148
    back = eng.decode_chunk(header, got)
    assert np.array_equal(back.seq_flat, block.seq_flat)
    assert eng.stats["device_chunks"] == eng.stats["device_decodes"] == 1


# ---------------------------------------------------------------------------
# the PE goldens through the CLI
# ---------------------------------------------------------------------------

PE_GOLDENS = [
    ("pe_R1", "pe_R2", "pe.ref.rfq", []),
    ("pe_big_R1", "pe_big_R2", "pe_big.ref.k100.rfq", ["-k", "100"]),
    ("pe_nov_R1", "pe_nov_R2", "pe_nov.ref.rfq", []),
    ("pe_nl1", "pe_nl2", "pe_nl.ref.rfq", ["-k", "100"]),
]


@pytest.mark.parametrize("r1,r2,golden,extra", PE_GOLDENS)
@pytest.mark.parametrize("workers", ["1", "4"])
def test_cli_pe_goldens_through_the_engine(tmp_path, monkeypatch, r1, r2,
                                           golden, extra, workers):
    """-i/-I in, -o/-O out through the port's CLI entry with its engine on
    the CPU device: reference bytes, both inputs back, every chunk on the
    device path both ways."""
    monkeypatch.setenv("REPAQ_DEVICE_MIN_BASES", "0")
    config = TE.make_engine_config("cpu")
    eng = config.encode_chunk.__self__  # the DeviceEngine, for its stats
    fq = []
    for base in (r1, r2):
        f = tmp_path / (base + ".fq")
        f.write_bytes(gzip.open(os.path.join(FX, base + ".fq.gz")).read())
        fq.append(f)
    out = tmp_path / "o.rfq"
    assert cli.main(["-c", "-i", str(fq[0]), "-I", str(fq[1]), "-o",
                     str(out), "-w", workers, *extra], engine=config) == 0
    with open(os.path.join(FX, golden), "rb") as f:
        assert out.read_bytes() == f.read()
    b1, b2 = tmp_path / "b1.fq", tmp_path / "b2.fq"
    assert cli.main(["-d", "-i", str(out), "-o", str(b1), "-O", str(b2),
                     "-w", workers], engine=config) == 0
    assert b1.read_bytes() == fq[0].read_bytes()
    assert b2.read_bytes() == fq[1].read_bytes()
    assert eng.stats["host_chunks"] == eng.stats["host_decodes"] == 0
    assert eng.stats["device_chunks"] == eng.stats["device_decodes"] > 0

