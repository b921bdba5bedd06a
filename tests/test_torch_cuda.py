"""The port's CUDA kernels against their plain torch versions, and the
engine on a CUDA device against the host engine. Every test here is marked
``cuda`` and skips without a card; on a machine with one:

    python -m pytest tests/test_torch_cuda.py -q

This file imports no JAX, so it runs where only torch is installed.
Everything is integer: the tolerance is exact equality."""

import os

import numpy as np
import pytest
import torch

from repaq_tpu_torch import cli as tcli
from repaq_tpu_torch.codec import rans_np as R
from repaq_tpu_torch.codec import vectorized
from repaq_tpu_torch.codec.device_engine import DeviceEngine
from repaq_tpu_torch.ops import _build
from repaq_tpu_torch.ops import kernels as TK
from repaq_tpu_torch.ops import rans_device as RD

from chip_smoke import (CONCAT_CASES, RUNS_CASES, chunk_calls, concat_args,
                        concat_case, concat_ref, parent_elide,
                        parent_qual_write, pe_chunk_calls, runs_args,
                        runs_case, runs_ref)
from chip_smoke import (PAIR_CASES, PAIR_LONG_CASES, pair_case,
                        pair_edge_cases, pairs_traced, parent_pe_decode,
                        parent_pe_encode)
from chip_smoke import (COMPACT_CALLS, COMPACT_CAPS, COMPACT_CASES,
                        COMPACT_FORMS,
                        COMPACT_PAST_WAVE, DECODE_CASES, FILL_CASES,
                        FILL_DTYPES, FRONT_CASES, FSM_KINDS, LAYOUT_CASES,
                        OVERLAP_CASES, PE_BASES,
                        RANS_CASES, RANS_SHAPES, RUN_KINDS, SEG_KINDS,
                        _decode_case_makers, compact_args, compact_case,
                        compact_ref, compact_seeded, compact_shapes,
                        compact_traced,
                        decode_case,
                        decode_case_inputs, fill_args, fill_case,
                        fill_chunk_inputs, fill_loop, front_case, fsm_case,
                        layout_case, overlap_case,
                        rans_case, rans_case_inputs, rans_shape_data,
                        run_case, seg_case)
from test_device_engine import _mk_block


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _seq(n, rng, n_frac):
    seq = rng.choice(np.frombuffer(b"GATC", dtype=np.uint8), size=n)
    seq[rng.random(n) < n_frac] = ord("N")
    return seq


def _frontend_case(n, seed, n_frac, esc):
    rng = np.random.default_rng(seed)
    seq = _seq(n, rng, n_frac)
    table = np.array([35, 44, 58], dtype=np.uint8)  # '#', ',', ':'
    major = 70  # 'F'
    qual = rng.choice(np.concatenate([table, np.full(12, major, np.uint8)]),
                      size=n).astype(np.uint8)
    if esc:
        qual[rng.integers(0, n, size=9)] = 99
    return seq, qual, table, major


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3, 4, 16, 17, 4 * 1001 + 1,
                               4 * 1001 + 2, 4 * 1001 + 3, 1 << 20,
                               (1 << 20) + 3])
def test_frontend_kernel_matches_plain(cuda, n):
    """Any n: n % 4 in {1, 2, 3} with 'N' and the major qual in the
    tail."""
    seq, qual, table, major = _frontend_case(n, n, 0.01, True)
    seq[-1], qual[-1] = ord("N"), major
    args = [torch.from_numpy(a) for a in (seq, qual, table)]
    want = TK.encode_frontend_plain(*[a.to(cuda) for a in args], major)
    before = TK.launches["encode_frontend"]
    got = TK.encode_frontend(*[a.to(cuda) for a in args], major)
    torch.cuda.synchronize()
    assert TK.launches["encode_frontend"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 4 * 1001 + 3, (1 << 20) + 12])
def test_frontend_bytes_kernel_matches_plain(cuda, n):
    seq, qual, table, major = _frontend_case(n, n, 0.01, True)
    args = [torch.from_numpy(a).to(cuda) for a in (seq, qual, table)]
    want = TK.encode_frontend_bytes_plain(*args, major)
    before = TK.launches["encode_frontend_bytes"]
    got = TK.encode_frontend_bytes(*args, major)
    torch.cuda.synchronize()
    assert TK.launches["encode_frontend_bytes"] == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 5, 16, 4 * 1001 + 1, (1 << 20) + 15])
def test_pack_kernel_matches_plain(cuda, n):
    rng = np.random.default_rng(n)
    seq = torch.from_numpy(_seq(n, rng, 0.01)).to(cuda)
    before = TK.launches["pack_bases"]
    got = TK.pack_bases(seq)
    torch.cuda.synchronize()
    assert TK.launches["pack_bases"] == before + 1
    assert torch.equal(got, TK.pack_bases_plain(seq))
    # a misaligned view is copied to an aligned buffer, not refused
    if n > 1:
        assert torch.equal(TK.pack_bases(seq[1:]),
                           TK.pack_bases_plain(seq[1:]))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["pack_bases", "encode_frontend_bytes"])
@pytest.mark.parametrize("case", FRONT_CASES)
def test_front_kernels_on_edge_cases(cuda, case, kernel):
    """chip_smoke.FRONT_CASES, placed by each kernel's built wave
    (kernels.frontend_waves()): every byte value at every position of a
    16-byte group, n = 63, 64, 65, one wave's bases and one either side, a
    view one byte off alignment, 2^24 + 5 bases and the PE chunk; one
    launch each, the byte form's outputs bool and int32."""
    wave = dict(zip(("pack_bases", "encode_frontend_bytes"),
                    TK.frontend_waves()))[kernel]
    seq, qual, bins, major, off = front_case(case, wave)
    seq_t = torch.from_numpy(seq).to(cuda)[off:]
    args = ((seq_t,) if kernel == "pack_bases" else
            (seq_t, torch.from_numpy(qual).to(cuda)[off:],
             torch.from_numpy(bins).to(cuda), major))
    before = TK.launches[kernel]
    got = getattr(TK, kernel)(*args)
    want = getattr(TK, kernel + "_plain")(*args)
    torch.cuda.synchronize()
    assert TK.launches[kernel] == before + 1
    if kernel == "pack_bases":
        got, want = (got,), (want,)
    else:
        assert [t.dtype for t in got] == [torch.uint8, torch.bool,
                                          torch.int32]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
def test_frontend_bytes_is_one_kernel_a_call(cuda):
    """At the PE chunk, a CUDA graph capture of one encode_frontend_bytes
    call holds its kernel and nothing else: no torch pass after it."""
    seq, qual, table, major = _frontend_case(PE_BASES, 5, 0.01, True)
    args = [torch.from_numpy(a).to(cuda) for a in (seq, qual, table)]
    traced = TK.captured_ops(lambda: TK.encode_frontend_bytes(*args, major))
    assert len(traced) == 1 and "frontend_bytes_kernel" in traced[0], traced


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 3, 4, 10_001, 1 << 20, 0, 15, 16, 17,
                               4096 + 13, 2_957_312])
def test_unpack_kernel_matches_plain(cuda, m):
    """Every tail: m % 4 bytes past the last word, m % 16 past a thread's
    four words, a partial last block; and the decode's chunk size."""
    rng = np.random.default_rng(m)
    packed = torch.from_numpy(rng.integers(0, 256, size=m, dtype=np.uint8))
    packed = packed.to(cuda)
    before = TK.launches["unpack_bases"]
    got = TK.unpack_bases(packed)
    torch.cuda.synchronize()
    assert TK.launches["unpack_bases"] == before + (m > 0)
    assert torch.equal(got, TK.unpack_bases_plain(packed))
    # a misaligned view is copied to an aligned buffer, not refused
    assert torch.equal(TK.unpack_bases(packed[1:]),
                       TK.unpack_bases_plain(packed[1:]))
    # into a larger buffer: the bytes past 4m stay as they were
    buf = torch.full((4 * m + 17,), 7, dtype=torch.uint8, device=cuda)
    assert torch.equal(TK.unpack_bases(packed, out=buf),
                       TK.unpack_bases_plain(packed))
    torch.cuda.synchronize()
    assert bool((buf[4 * m:] == 7).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32])
@pytest.mark.parametrize("kind", FSM_KINDS)
@pytest.mark.parametrize("tiles,extra", [(0, 1), (1, -1), (1, 0), (1, 1),
                                         (3000, 5)])
def test_token_fsm_kernel_matches_plain(cuda, tiles, extra, kind, dtype):
    """One launch per call, exact against the plain version at n = 1,
    tile - 1, tile, tile + 1 and past 3,000 tiles, for every edge-case
    kind of chip_smoke.fsm_case (lengths outside 1..4 included), uint8 and
    int32 lengths."""
    tile = TK.fsm_tile()
    n = tiles * tile + extra
    lens, force = fsm_case(n, kind, n, tile)
    lens = torch.from_numpy(lens).to(cuda).to(dtype)
    force = None if force is None else torch.from_numpy(force).to(cuda)
    before = TK.launches["token_start_mask"]
    got = TK.token_start_mask(lens, force)
    torch.cuda.synchronize()
    assert TK.launches["token_start_mask"] == before + 1
    assert torch.equal(got, TK.token_start_mask_plain(lens, force))


# n at the tiles' edges: 1, tile - 1, tile, tile + 1, 3 tiles + 5 (a
# run of the "long" kind spans three tiles), past one look-back window (33
# tiles) and 700 tiles + 3; every n but the tile multiples has n % 16 != 0
TILE_EDGES = [(0, 1), (1, -1), (1, 0), (1, 1), (3, 5), (33, 0), (700, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [0, 2])
@pytest.mark.parametrize("kind", RUN_KINDS)
@pytest.mark.parametrize("tiles,extra", TILE_EDGES)
def test_run_offsets_tile_edges(cuda, tiles, extra, kind, rows):
    """One launch per call, exact against the plain version: runs of
    31/32/33 ending at, across and one past the steps', warps' and tiles'
    ends, a run over three tiles, all set and none, 1-D and as 2 rows (the
    second row starts unaligned where n % 16 != 0)."""
    tile = TK.run_tiles()[0]
    n = tiles * tile + extra
    x = torch.from_numpy(run_case(n, rows, kind, n + rows, tile)).to(cuda)
    before = TK.launches["run_offsets"]
    got = TK.run_offsets(x)
    torch.cuda.synchronize()
    assert TK.launches["run_offsets"] == before + 1
    for g, w in zip(got, TK.run_offsets_plain(x)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", SEG_KINDS)
@pytest.mark.parametrize("tiles,extra", TILE_EDGES)
def test_seg_positions_tile_edges(cuda, tiles, extra, kind):
    """One launch per call, exact against the plain version: segment starts
    at none but the first, at every element, at none, around every warp's
    and tile's edge, and at random, with stretches of adv == 0."""
    tile = TK.run_tiles()[1]
    n = tiles * tile + extra
    adv, start = (torch.from_numpy(a).to(cuda)
                  for a in seg_case(n, kind, n, tile))
    before = TK.launches["seg_positions"]
    got = TK.seg_positions(adv, start)
    torch.cuda.synchronize()
    assert TK.launches["seg_positions"] == before + 1
    assert torch.equal(got, TK.seg_positions_plain(adv, start))


@pytest.mark.cuda
def test_run_kernels_on_views_and_empty_inputs(cuda):
    """Inputs whose start is not 16-byte aligned and strided ones give what
    their values give; empty ones launch nothing."""
    run_tile, seg_tile = TK.run_tiles()
    x = torch.from_numpy(run_case(3 * run_tile + 9, 2, "dense", 5)).to(cuda)
    for v in (x[0, 1:], x[:, ::3], x[:, 1:]):
        for g, w in zip(TK.run_offsets(v), TK.run_offsets_plain(v)):
            assert torch.equal(g, w)
    adv, start = (torch.from_numpy(a).to(cuda)
                  for a in seg_case(3 * seg_tile + 9, "random", 5))
    for sl in (slice(1, None), slice(None, None, 3)):
        assert torch.equal(TK.seg_positions(adv[sl], start[sl]),
                           TK.seg_positions_plain(adv[sl], start[sl]))
    before = dict(TK.launches)
    for shape in ((0,), (2, 0)):
        off, to_end = TK.run_offsets(torch.zeros(shape, dtype=torch.bool,
                                                 device=cuda))
        assert off.shape == to_end.shape == shape
    assert TK.seg_positions(adv[:0], start[:0]).shape == (0,)
    assert TK.launches == before
    with pytest.raises(ValueError):
        TK.run_offsets(x.to(torch.uint8))


@pytest.mark.cuda
def test_run_kernels_leave_their_status_words_zeroed(cuda):
    """Calls in a row on one stream share its status buffer with no fill
    between them: each is exact, a larger call takes a larger buffer, and
    every buffer is all zero once the launches have ended."""
    run_tile, seg_tile = TK.run_tiles()
    for tiles in (1, 700, 3, 1400, 2):
        x = torch.from_numpy(run_case(tiles * run_tile + 7, 2, "dense",
                                      tiles)).to(cuda)
        for g, w in zip(TK.run_offsets(x), TK.run_offsets_plain(x)):
            assert torch.equal(g, w)
        adv, start = (torch.from_numpy(a).to(cuda) for a in seg_case(
            tiles * seg_tile + 7, "random", tiles))
        assert torch.equal(TK.seg_positions(adv, start),
                           TK.seg_positions_plain(adv, start))
    torch.cuda.synchronize()
    assert TK._run_status
    for buf in TK._run_status.values():
        assert not bool(buf.any())


@pytest.mark.cuda
def test_kernel_build_is_cached_by_content(cuda):
    path = _build._build()
    assert os.path.exists(path) and _build._build() == path


@pytest.mark.cuda
def test_engine_on_cuda_matches_host(cuda):
    eng = DeviceEngine(cuda, min_bases=0)
    TK.reset_launches()
    block = _mk_block(600, 101, seed=3, nfrac=0.01)
    header = vectorized.make_header_se(block)
    got = eng.encode_chunk(header, block, False)
    assert got.to_bytes() == vectorized.encode_chunk(header, block,
                                                     False).to_bytes()
    back = eng.decode_chunk(header, got)
    assert np.array_equal(back.seq_flat, block.seq_flat)
    assert np.array_equal(back.qual_flat, block.qual_flat)
    assert eng.stats["device_chunks"] == eng.stats["device_decodes"] == 1
    for name in ("encode_frontend", "unpack_bases", "token_start_mask",
                 "run_offsets", "seg_positions"):
        assert TK.launches[name] > 0, TK.launches


@pytest.mark.cuda
def test_pe_engine_on_cuda_matches_host(cuda):
    """One PE-interleaved chunk with overlaps and Ns through the engine on
    the card: the host engine's bytes, the input back, the kernels of the
    PE path launched, and the pair work as one pe_encode_pairs and one
    pe_decode_rows launch (no overlap_pairs)."""
    eng = DeviceEngine(cuda, min_bases=0)
    TK.reset_launches()
    block = _mk_block(600, 96, seed=7, pe_overlap=0.5, nfrac=0.01)
    header = vectorized.make_header_pe(block)
    got = eng.encode_chunk(header, block, True)
    assert got.to_bytes() == vectorized.encode_chunk(header, block,
                                                     True).to_bytes()
    back = eng.decode_chunk(header, got)
    assert np.array_equal(back.seq_flat, block.seq_flat)
    assert np.array_equal(back.qual_flat, block.qual_flat)
    assert eng.stats["device_chunks"] == eng.stats["device_decodes"] == 1
    for name in ("encode_frontend", "unpack_bases", "token_start_mask",
                 "run_offsets", "seg_positions"):
        assert TK.launches[name] > 0, TK.launches
    # the pair work: one launch of each pair kernel a chunk, the search
    # inside the encode's, none of the search alone
    assert TK.launches["pe_encode_pairs"] == 1
    assert TK.launches["pe_decode_rows"] == 1
    assert TK.launches["overlap_pairs"] == 0
    assert TK.launches["encode_frontend_bytes"] == 0  # the meta route


def _round_robin(stats, key):
    """Every chunk on the device, the k-th on engine k mod D."""
    got = [s[key] for s in stats["engines"]]
    n, d = sum(got), len(got)
    assert n > 0 and got == [(n - i + d - 1) // d for i in range(d)], got


@pytest.mark.cuda
@pytest.mark.parametrize("base,golden,pe", [
    ("se_big", "se_big.ref.k100.rfq", False),
    ("pe_big", "pe_big.ref.k100.rfq", True)])
def test_mesh_on_cuda_matches_goldens(cuda, fixtures_dir, tmp_path,
                                      monkeypatch, base, golden, pe):
    """Two engines on one card (and every card when there are more): the
    golden bytes out, the input back, chunk k on engine k mod D."""
    from repaq_tpu_torch.parallel import mesh_engine as M

    monkeypatch.setenv("REPAQ_DEVICE_MIN_BASES", "0")
    devices = ["cuda:0"] * 2
    if torch.cuda.device_count() > 1:
        devices = M.cuda_devices()
    ins = ([str(fixtures_dir / (base + "_R1.fq")),
            str(fixtures_dir / (base + "_R2.fq"))] if pe
           else [str(fixtures_dir / (base + ".fq"))])
    out = tmp_path / "m.rfq"
    if pe:
        stats = M.compress_pe_mesh(*ins, str(out), chunk_size=100_000,
                                   devices=devices)
    else:
        stats = M.compress_se_mesh(*ins, str(out), chunk_size=100_000,
                                   devices=devices)
    assert out.read_bytes() == (fixtures_dir / golden).read_bytes()
    _round_robin(stats, "device_chunks")
    backs = [tmp_path / ("b%d.fq" % i) for i in range(len(ins))]
    stats = M.decompress_se_mesh(str(out), str(backs[0]), devices=devices,
                                 out2=str(backs[1]) if pe else "")
    _round_robin(stats, "device_decodes")
    for src, back in zip(ins, backs):
        assert back.read_bytes() == open(src, "rb").read()


@pytest.mark.cuda
@pytest.mark.parametrize("base,golden,pe", [
    ("se_big", "se_big.ref.k100.rfq", False),
    ("pe_big", "pe_big.ref.k100.rfq", True)])
def test_shards_on_cuda_match_goldens(cuda, fixtures_dir, tmp_path, base,
                                      golden, pe):
    """--num_shards 3 --engine device, the shards run in turn in this
    process on one engine: the golden bytes out (shard 0 assembles last),
    then the input back, every chunk on the card both ways."""
    eng = DeviceEngine("cuda:0", min_bases=0)
    ins = (["-i", str(fixtures_dir / (base + "_R1.fq")),
            "-I", str(fixtures_dir / (base + "_R2.fq"))] if pe
           else ["-i", str(fixtures_dir / (base + ".fq"))])
    out = tmp_path / "s.rfq"
    backs = [tmp_path / ("b%d.fq" % i) for i in range(1 + pe)]
    outs = ["-o", str(backs[0])] + (["-O", str(backs[1])] if pe else [])
    for argv in (["-c", *ins, "-o", str(out), "-k", "100"],
                 ["-d", "-i", str(out), *outs]):
        for shard in (2, 1, 0):
            assert tcli.main([*argv, "--engine", "device", "--num_shards",
                              "3", "--shard", str(shard)],
                             engine=eng.config()) == 0
    assert out.read_bytes() == (fixtures_dir / golden).read_bytes()
    for src, back in zip(ins[1::2], backs):
        assert back.read_bytes() == open(src, "rb").read()
    st = eng.stats
    assert st["host_chunks"] == st["host_decodes"] == 0
    assert st["device_chunks"] == st["device_decodes"] > 0


@pytest.mark.cuda
def test_torchdist_nccl_one_rank_matches_golden(cuda, fixtures_dir,
                                                tmp_path, monkeypatch):
    """compress_distributed_torch over NCCL at world size 1, the engine on
    cuda:0 and a 4 KB slab (many gather rounds): the golden bytes."""
    import datetime

    import torch.distributed as tdist

    from repaq_tpu_torch.parallel import torchdist as T

    monkeypatch.setattr(T, "_SLAB", 4096)
    eng = DeviceEngine("cuda:0", min_bases=0)
    out = tmp_path / "t.rfq"
    timings = {}
    tdist.init_process_group(
        "nccl", init_method="file://" + str(tmp_path / "rdv"), world_size=1,
        rank=0, timeout=datetime.timedelta(seconds=120))
    try:
        T.compress_distributed_torch(
            str(fixtures_dir / "se_big.fq"), str(out), chunk_size=100_000,
            engine=eng.config(), timings=timings)
    finally:
        tdist.destroy_process_group()
    assert out.read_bytes() == (
        fixtures_dir / "se_big.ref.k100.rfq").read_bytes()
    assert timings["rounds"] > 1 and eng.stats["device_chunks"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("L1,L2", [(150, 150), (150, 101), (77, 150)])
def test_overlap_search_on_cuda_matches_cpu(cuda, L1, L2):
    """The overlap kernel against its plain version on the card, one
    launch: on strided views of one buffer (the engine's odd and even rows
    of a grid, or rows at odd offsets), with L1 != L2, and the CPU's
    answer."""
    rng = np.random.default_rng(L1 + L2)
    r1 = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(3000, L1))
    r2 = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(3000, L2))
    minlen = min(L1, L2)
    for i in range(0, 3000, 3):
        o = int(rng.integers(12, minlen + 1))
        r2[i, :o] = r1[i, L1 - o:]
    for i in range(1, 3000, 3):
        o = int(rng.integers(12, minlen + 1))
        r1[i, :o] = r2[i, L2 - o:]
    want = TK.overlap_pairs(torch.from_numpy(r1), torch.from_numpy(r2))
    assert (want > 0).any() and (want < 0).any()
    wide = torch.zeros((3000, L1 + L2 + 3), dtype=torch.uint8, device=cuda)
    wide[:, 1:1 + L1] = torch.from_numpy(r1).to(cuda)
    wide[:, 3 + L1:] = torch.from_numpy(r2).to(cuda)
    views = [(wide[:, 1:1 + L1], wide[:, 3 + L1:])]
    if L1 == L2:
        grid = torch.stack([views[0][0], views[0][1]], 1).reshape(6000, L1)
        views.append((grid[0::2], grid[1::2]))
    for a, b in views:
        before = TK.launches["overlap_pairs"]
        got = TK.overlap_pairs(a, b)
        assert TK.launches["overlap_pairs"] == before + 1
        assert torch.equal(got, TK.overlap_pairs_plain(a, b))
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", OVERLAP_CASES)
def test_overlap_edge_cases_on_cuda(cuda, name):
    """chip_smoke's overlap edge cases: the kernel against its plain
    version on the card, one launch."""
    r1, r2 = (torch.from_numpy(a).to(cuda) for a in overlap_case(name))
    before = TK.launches["overlap_pairs"]
    got = TK.overlap_pairs(r1, r2)
    assert TK.launches["overlap_pairs"] == before + 1
    assert torch.equal(got, TK.overlap_pairs_plain(r1, r2))


@pytest.mark.cuda
def test_pe_pair_tiles_by_read_length(cuda):
    """The built pair tiles: 32 pairs at 150 bp both ways, fewer for long
    reads, one pair (in one stage) at 20,000 bases, and past what one
    pair's tile holds 0: the encode's long route and the decode's direct
    route, up to the engine's longest read (65,535 bases)."""
    assert TK.pe_pair_tile(150) == TK.pe_pair_tile(150, 1) == 32
    assert TK.pe_pair_tile(150, 2) == 32
    assert 1 < TK.pe_pair_tile(1000) < 32
    assert TK.pe_pair_tile(20000) == TK.pe_pair_tile(20000, 1) == 1
    for L in (40000, 65535):
        assert TK.pe_pair_tile(L) == TK.pe_pair_tile(L, 1) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", PAIR_CASES + PAIR_LONG_CASES)
def test_pair_kernels_on_edge_cases(cuda, name):
    """chip_smoke's PAIR_CASES and PAIR_LONG_CASES placed by the built
    encode tile: pe_encode_pairs against its plain version (ov and both
    grids), then pe_decode_rows on the encoded grid (with the case's nbq,
    with ':', and with wild tables for pad_rows) against its plain version
    and the case's reads, one launch each."""
    assert pair_edge_cases(cuda, (name,)) == (4 if name == "pad_rows"
                                               else 3)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 5, 15])
def test_pe_encode_pairs_on_unaligned_grids(cuda, offset):
    """Grids that start off 16 bytes (views into a wider buffer): one
    launch, the plain version's ov and rows, the bytes around the grids
    untouched."""
    seq, qual, n, shift, search, _nbq = pair_case("odd_pairs",
                                                  TK.pe_pair_tile)
    bufs, views = [], []
    for a in (seq, qual):
        buf = torch.full((a.size + 32,), 7, dtype=torch.uint8, device=cuda)
        buf[offset:offset + a.size] = torch.from_numpy(a.reshape(-1)).to(cuda)
        bufs.append(buf)
        views.append(buf[offset:offset + a.size].view(a.shape))
    before = TK.launches["pe_encode_pairs"]
    ov = TK.pe_encode_pairs(*views, n, shift, search)
    assert TK.launches["pe_encode_pairs"] == before + 1
    s, q = torch.from_numpy(seq).to(cuda), torch.from_numpy(qual).to(cuda)
    assert torch.equal(ov, TK.pe_encode_pairs_plain(s, q, n, shift, search))
    assert torch.equal(views[0], s) and torch.equal(views[1], q)
    for buf, a in zip(bufs, (seq, qual)):
        assert (buf[:offset] == 7).all() and (buf[offset + a.size:]
                                              == 7).all()


@pytest.mark.cuda
def test_pair_kernels_at_a_real_pe_chunk(cuda):
    """The pair kernels at one real PE chunk's calls recorded through
    cli.main (chip_smoke.pe_chunk_calls: 40,000 pairs, b_cap 98,304):
    each equal to its plain version and to the parent's composition, and
    one device kernel a call in a CUDA graph capture."""
    rec = pe_chunk_calls(cuda)
    seq_mat, qual_mat, n_pairs, shift, search = rec["pe_encode_pairs"]
    s1, q1, s2, q2 = (x.clone() for x in (seq_mat, qual_mat) * 2)
    ov = TK.pe_encode_pairs(s1, q1, n_pairs, shift, search)
    assert torch.equal(ov, TK.pe_encode_pairs_plain(s2, q2, n_pairs, shift,
                                                    search))
    assert torch.equal(s1, s2) and torch.equal(q1, q2)
    pov, ps, pq = parent_pe_encode(seq_mat, qual_mat, n_pairs, shift,
                                   search)()
    assert torch.equal(ov, pov) and torch.equal(s1, ps) and torch.equal(q1,
                                                                        pq)
    assert (ov > 0).any() and (ov < 0).any()
    stored, qual, tables, L, nbq = rec["pe_decode_rows"]
    got = TK.pe_decode_rows(stored, qual, tables, L, nbq)
    assert torch.equal(got, TK.pe_decode_rows_plain(stored, qual, tables, L,
                                                    nbq))
    assert torch.equal(got, parent_pe_decode(stored.clone(), qual.clone(),
                                             tables, L, nbq)())
    # captured in CUDA graphs (chip_smoke.pairs_traced)
    enc_kernels, dec_kernels = pairs_traced(rec)
    assert len(enc_kernels) == 1 and "pe_encode_kernel" in enc_kernels[0]
    assert len(dec_kernels) == 1 and "pe_decode_kernel" in dec_kernels[0]


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True])
def test_stream_coders_on_cuda_match_cpu(cuda, monkeypatch, wide):
    """The stream coders give the same bytes on the card as on the CPU:
    the compactions, layout writes and int32 scans behave alike, and no
    CUDA tensor reaches a kernel's plain version. wide: a length that is
    no multiple of the kernels' tiles (JAX's wide emission layout, which
    this parameter once switched, has no counterpart in the port)."""
    from repaq_tpu_torch.codec import kernels_np as K
    from repaq_tpu_torch.ops import device_streams as T

    def on_cpu_only(plain):
        def run(*args, **kw):
            tensors = [a for a in (*args, *kw.values())
                       if isinstance(a, torch.Tensor)]
            assert all(t.device.type == "cpu" for t in tensors)
            return plain(*args, **kw)
        return run

    for name in ("bucket_compact_plain", "fill_runs_plain"):
        monkeypatch.setattr(TK, name, on_cpu_only(getattr(TK, name)))
    rng = np.random.default_rng(5)
    n = (1 << 16) + (13 if wide else 0)
    table = np.array([35, 44, 58], dtype=np.uint8)
    qual = rng.choice(np.concatenate([table, np.full(9, 70, np.uint8)]),
                      size=n).astype(np.uint8)
    qual[rng.integers(0, n, size=7)] = 99
    qual[1000:3000] = 44  # a long run
    lut = np.full(256, 3, dtype=np.uint8)
    lut[table] = np.arange(3)
    lut[70] = 4
    meta = lut[qual] | ((rng.random(n) < 0.01).astype(np.uint8) << 7)
    xy = rng.integers(1000, 40000, size=(2, 700)).astype(np.int32)

    def encode(dev):
        m, q = torch.from_numpy(meta).to(dev), torch.from_numpy(qual).to(dev)
        return [
            *T.qualcol_encode_device(m, q, 3, esc_cap=16),
            *T.qualcol_encode_device(m, q, 3, esc_cap=0),
            *T.encode_positions_from_meta(m, n, n // 8, pos_cap=1024),
            *T.encode_positions_from_mask(m >= 0x80, n // 8, pos_cap=1024),
            *T.qualcol_encode_device(None, q, 3, esc_cap=16,
                                     bid=(m & 0x7F).int()),
            *T.coords_encode2_device(torch.from_numpy(xy).to(dev), 2108,
                                     n_valid=650),
        ]

    for g, w in zip(encode(cuda), encode("cpu")):
        assert torch.equal(g.cpu(), w)

    enc = K.encode_qual_by_col(qual, table, 70)
    buf = np.zeros(enc.shape[0] + 64, dtype=np.uint8)
    buf[: enc.shape[0]] = enc
    for run_cap in (None, 4096):
        got = T.qualcol_decode_device(
            torch.from_numpy(buf).to(cuda), 3,
            torch.from_numpy(table).to(cuda), 70, n, enc.shape[0],
            esc_cap=16, run_cap=run_cap)
        assert np.array_equal(got.cpu().numpy(), qual)


def _rans_data(n, order, seed):
    """Quality-like bytes with context for order-1, a skewed alphabet
    with a random tail for order-0."""
    rng = np.random.default_rng(seed)
    if order:
        return rng.choice(np.frombuffer(b"F:,#", np.uint8), size=n,
                          p=[0.86, 0.09, 0.04, 0.01])
    data = rng.choice(np.frombuffer(b"ACGTACGTN\x00\xff", np.uint8), size=n)
    data[-(n // 8):] = rng.integers(0, 256, size=n // 8, dtype=np.uint8)
    return data


@pytest.mark.cuda
@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("n,lanes", [(16 * 300, 16), (1003, 64),
                                     (2048 * 1115 + 2003, 2048),
                                     (4096 * 400, 4096)])
def test_rans_kernels_match_plain(cuda, order, n, lanes):
    """rans_encode, rans_layout and rans_decode against their plain
    versions on the card, equal and ragged splits."""
    data = _rans_data(n, order, n + order)
    _head, freqs, cum = RD.section_prologue(data, order, lanes)
    d = torch.from_numpy(data).to(cuda)
    f = torch.from_numpy(freqs.astype(np.int32)).to(cuda)
    c = torch.from_numpy(cum.astype(np.int32)).to(cuda)
    before = dict(TK.launches)
    got = RD.rans_encode_device(d, f, c, lanes, order)
    want = RD.rans_encode_plain(d, f, c, lanes, order)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w.cpu())
    cap = 2 * n + 4 * lanes + 8
    payload, lane_bytes, total = RD.rans_encode_payload_device(
        d, f, c, lanes, order, cap)
    start = torch.cumsum(lane_bytes, 0) - lane_bytes
    assert torch.equal(payload, RD.rans_layout_plain(*want, start, cap))
    sym = RD._parse_tables(memoryview(_head), 7, order)[2]
    args = (payload[:int(total)], lane_bytes, torch.from_numpy(sym).to(cuda),
            f, c, lanes, 0, order)
    off = R.lane_slices(n, lanes)
    out = RD.rans_decode_device(*args, offsets=off)
    torch.cuda.synchronize()
    assert np.array_equal(out.cpu().numpy(), data)
    assert torch.equal(out, RD.rans_decode_plain(*args, offsets=off))
    for name, k in (("rans_encode", 2), ("rans_layout", 1),
                    ("rans_decode", 1)):
        assert TK.launches[name] == before[name] + k


def _encode_held(cuda, order, data, lanes, shift=0):
    """rans_encode on the card against its plain version (words, emits,
    final), one launch, and the section's bytes against the host
    coder's."""
    d, f, c = rans_case_inputs(cuda, order, data, lanes, shift)
    before = TK.launches["rans_encode"]
    got = RD.rans_encode_device(d, f, c, lanes, order)
    want = RD.rans_encode_plain(d, f, c, lanes, order)
    torch.cuda.synchronize()
    assert TK.launches["rans_encode"] == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert (RD.encode_section_device(data, order, lanes, device=cuda)
            == R.encode_section(data, order=order, lanes=lanes))


@pytest.mark.cuda
@pytest.mark.parametrize("name", RANS_CASES)
def test_rans_encode_staging_edges(cuda, name):
    """The edges of the encode kernel's staged windows (chip_smoke's
    RANS_CASES, placed by the built kernel's window)."""
    order, data, lanes, shift = rans_case(name, RD.encode_window())
    _encode_held(cuda, order, data, lanes, shift)


@pytest.mark.cuda
@pytest.mark.parametrize("index", range(len(RANS_SHAPES)))
def test_rans_encode_at_rans_shapes(cuda, index):
    order, data, lanes = list(rans_shape_data())[index]
    _encode_held(cuda, order, data, lanes)


def _layout_held(args, cap):
    """rans_layout on the card against its plain version, one launch."""
    before = TK.launches["rans_layout"]
    got = RD.rans_layout(*args, cap)
    torch.cuda.synchronize()
    assert TK.launches["rans_layout"] == before + 1
    assert got.shape == (cap,) and torch.equal(
        got, RD.rans_layout_plain(*args, cap))


@pytest.mark.cuda
@pytest.mark.parametrize("name", LAYOUT_CASES)
def test_rans_layout_tile_edges(cuda, name):
    """The edges of the layout kernel's tiles (chip_smoke's LAYOUT_CASES,
    placed by the built tile, rans_device.layout_tile())."""
    *arrays, cap = layout_case(name, RD.layout_tile())
    _layout_held([torch.from_numpy(a).to(cuda) for a in arrays], cap)


@pytest.mark.cuda
def test_rans_layout_unaligned_inputs(cuda):
    """Words and emits that start 2 and 1 bytes past an aligned address,
    with lanes % 16 == 0, take the element-wise staging."""
    steps, lanes = RD.layout_tile()
    words, emits, final, start, cap = layout_case("steps 2 T + 1",
                                                  (steps, lanes))
    w = torch.zeros(words.size + 1, dtype=torch.uint16, device=cuda)
    e = torch.zeros(emits.size + 1, dtype=torch.bool, device=cuda)
    w[1:] = torch.from_numpy(words.reshape(-1)).to(cuda)
    e[1:] = torch.from_numpy(emits.reshape(-1)).to(cuda)
    _layout_held([w[1:].view(words.shape), e[1:].view(emits.shape),
                  torch.from_numpy(final).to(cuda),
                  torch.from_numpy(start).to(cuda)], cap)


@pytest.mark.cuda
@pytest.mark.parametrize("index", range(len(RANS_SHAPES)))
def test_rans_layout_at_rans_shapes(cuda, index):
    """The layout of the encoder's outputs at RANS_SHAPES, with the
    section coder's starts and cap."""
    order, data, lanes = list(rans_shape_data())[index]
    d, f, c = rans_case_inputs(cuda, order, data, lanes, 0)
    words, emits, final = RD.rans_encode_device(d, f, c, lanes, order)
    size = 4 + 2 * emits.sum(0)
    _layout_held([words, emits, final, torch.cumsum(size, 0) - size],
                 2 * data.shape[0] + 4 * lanes + 8)


def _decode_route(name, window, rows):
    """The route rans_decode must take on a DECODE_CASES case: the
    qualities' and the limit's tables in shared memory, one past the limit
    and all contexts live from global memory."""
    order, _n, _lanes, _shift, kind = _decode_case_makers(window, rows)[name]
    if order == 0 or kind != "uniform" and not name.endswith("past the "
                                                             "shared limit"):
        return "shared"
    return "global"


@pytest.mark.cuda
@pytest.mark.parametrize("name", DECODE_CASES)
def test_rans_decode_edges(cuda, name):
    """The edges of the decode kernel (chip_smoke's DECODE_CASES, placed
    by the built window and shared limit) against its plain version and
    the data, one launch each, on the route its live contexts choose."""
    window, rows = RD.decode_window(), RD.decode_shared_rows()
    order, data, lanes, shift = decode_case(name, window, rows)
    args, off = decode_case_inputs(cuda, order, data, lanes, shift)
    before = TK.launches["rans_decode"]
    routes = dict(RD.decode_routes)
    got = RD.rans_decode_device(*args, offsets=off)
    torch.cuda.synchronize()
    assert TK.launches["rans_decode"] == before + 1
    route = _decode_route(name, window, rows)
    assert RD.last_decode[2] == route
    assert RD.decode_routes[route] == routes[route] + 1
    assert np.array_equal(got.cpu().numpy(), data)
    assert torch.equal(got, RD.rans_decode_plain(*args, offsets=off))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["o1 live contexts at the shared limit",
                                  "o1 uniform random bytes",
                                  "o0 lanes of window + 1"])
def test_rans_decode_corrupt_payload(cuda, name):
    """A payload of other bytes, one shifted to an odd address and lane
    counts that run past it: the kernel returns on either route and gives
    the right shape, and the bytes around the payload in its allocation
    (0x00 in one run, 0xFF in the other) never change the output, so every
    byte it decodes comes from inside the payload."""
    window, rows = RD.decode_window(), RD.decode_shared_rows()
    order, data, lanes, _shift = decode_case(name, window, rows)
    args, off = decode_case_inputs(cuda, order, data, lanes, 0)
    rng = np.random.default_rng(lanes)
    payload = torch.from_numpy(rng.integers(
        0, 256, size=args[0].shape[0] // 2 + 1, dtype=np.uint8)).to(cuda)
    plen = payload.shape[0]
    for shift, extra in ((0, 0), (1, 3)):
        outs = []
        for fill in (0x00, 0xFF):
            buf = torch.full((plen + 64,), fill, dtype=torch.uint8,
                             device=cuda)
            p = buf[32 + shift:32 + plen]
            p.copy_(payload[shift:])
            outs.append(RD.rans_decode_device(p, args[1] + extra, *args[2:],
                                              offsets=off))
            torch.cuda.synchronize()
            assert outs[-1].shape == (data.shape[0],)
            assert RD.last_decode[2] == _decode_route(name, window, rows)
        assert torch.equal(*outs)


@pytest.mark.cuda
@pytest.mark.parametrize("order,n,lanes", [(0, 16_000_000, 4096),
                                           (1, 3_000_001, 2048)])
def test_rans_sections_on_cuda_match_host(cuda, order, n, lanes):
    data = _rans_data(n, order, 7)
    enc = RD.encode_section_device(data, order, lanes, device=cuda)
    assert enc == R.encode_section(data, order=order, lanes=lanes)
    dec, off = RD.decode_section_device(enc, device=cuda)
    assert dec == data.tobytes() and off == len(enc)


@pytest.mark.cuda
@pytest.mark.parametrize("pe", [False, True])
def test_cli_rfqz_engine_device_matches_host_coder(cuda, fixtures_dir,
                                                   tmp_path, pe):
    """A .rfqz compress under --engine device (device engine, device
    rANS) writes the bytes of --engine vectorized (host engine, host
    coder). With -k 100 the engine's workers run several chunks on the
    card while the main thread codes their sections there."""
    ins = (["-i", str(fixtures_dir / "pe_big_R1.fq"), "-I",
            str(fixtures_dir / "pe_big_R2.fq")] if pe
           else ["-i", str(fixtures_dir / "se_big.fq")])
    for extra in ([], ["-k", "100"]):
        eng = DeviceEngine(cuda, min_bases=0)
        outs = []
        TK.reset_launches()
        for engine in ("device", "vectorized"):
            out = tmp_path / (engine + ".rfqz")
            assert tcli.main(["-c", *ins, "-o", str(out), *extra,
                              "--engine", engine],
                             engine=eng.config() if engine == "device"
                             else None) == 0
            outs.append(out.read_bytes())
        assert outs[0] == outs[1]
        assert eng.stats["device_chunks"] > 0
        if extra:
            assert eng.stats["device_chunks"] > 1
        assert TK.launches["rans_encode"] > 0
        assert TK.launches["rans_layout"] == TK.launches["rans_encode"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", FILL_DTYPES)
@pytest.mark.parametrize("name", FILL_CASES)
def test_fill_runs_edges(cuda, name, dtype):
    """fill_runs against its plain version and a numpy loop on every
    FILL_CASES case, one launch each (none for no entries), the elements
    around the written view left alone."""
    case = fill_case(name, dtype)
    buf, out, start, count, value, keep = fill_args(case, cuda)
    before = TK.launches["fill_runs"]
    got = TK.fill_runs(out, start, count, value, keep)
    torch.cuda.synchronize()
    assert TK.launches["fill_runs"] == before + (start.shape[0] > 0)
    _b, pout, pstart, pcount, pvalue, pkeep = fill_args(case, cuda)
    want = TK.fill_runs_plain(pout, pstart, pcount, pvalue, pkeep)
    assert torch.equal(got, want)
    off = case[5]
    assert np.array_equal(got.cpu().numpy(), fill_loop(
        case[0][off:], case[1], case[2], case[3], case[4]))
    assert np.array_equal(buf.cpu().numpy()[:off], case[0][:off])


@pytest.mark.cuda
def test_fill_runs_at_the_se_chunk(cuda):
    """fill_runs on one SE decode chunk's quality writes (FILL_CHUNK)
    against its plain version, one launch."""
    out, start, count, value, keep = fill_chunk_inputs(cuda)
    want = TK.fill_runs_plain(out.clone(), start, count, value, keep)
    before = TK.launches["fill_runs"]
    got = TK.fill_runs(out, start, count, value, keep)
    assert TK.launches["fill_runs"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", RUNS_CASES)
def test_fill_sorted_runs_edges(cuda, name):
    """fill_sorted_runs against its plain version and the numpy generic
    composition on chip_smoke's RUNS_CASES placed by the built tile, one
    launch each (two kernels)."""
    case = runs_case(name, TK.sorted_runs_tile())
    args = runs_args(case, cuda)
    before = TK.launches["fill_sorted_runs"]
    got = TK.fill_sorted_runs(*args)
    torch.cuda.synchronize()
    assert TK.launches["fill_sorted_runs"] == before + 1
    assert torch.equal(got, TK.fill_sorted_runs_plain(*args))
    assert np.array_equal(got.cpu().numpy(), runs_ref(*case))


@pytest.mark.cuda
@pytest.mark.parametrize("name", CONCAT_CASES)
def test_concat_row_spans_edges(cuda, name):
    """concat_row_spans against its plain version and a row-by-row numpy
    copy on chip_smoke's CONCAT_CASES placed by the built tile, one launch
    each."""
    case = concat_case(name, TK.sorted_runs_tile())
    args = concat_args(case, cuda)
    before = TK.launches["concat_row_spans"]
    got = TK.concat_row_spans(*args)
    torch.cuda.synchronize()
    assert TK.launches["concat_row_spans"] == before + 1
    assert torch.equal(got, TK.concat_row_spans_plain(*args))
    assert np.array_equal(got.cpu().numpy(), concat_ref(*case))


@pytest.mark.cuda
def test_sorted_runs_at_the_real_chunks(cuda):
    """Both entries at the calls of one real chunk, recorded through the
    CLI: an SE decode's quality write against its plain version and the
    parent's composition, a PE encode's elision against its plain version
    and the parent's _elide."""
    args = chunk_calls(cuda)["fill_sorted_runs"][0]
    got = TK.fill_sorted_runs(*args)
    assert torch.equal(got, TK.fill_sorted_runs_plain(*args))
    assert torch.equal(got, parent_qual_write(*args)())
    rec = pe_chunk_calls(cuda)
    cargs = rec["concat_row_spans"]
    assert torch.equal(TK.concat_row_spans(*cargs),
                       TK.concat_row_spans_plain(*cargs))
    from repaq_tpu_torch.codec import device_engine as DE
    for x, y in zip(DE._elide(*rec["elide"]), parent_elide(*rec["elide"])):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_sorted_runs_from_threads_on_one_stream(cuda):
    """Calls from 8 threads on one stream (a call's two kernels may have
    other calls' between them, each with scratch of its own), all exact."""
    import threading

    tile = TK.sorted_runs_tile()
    cases = [runs_case(n, tile) for n in ("wrap", "later_wins", "segments63",
                                          "one_segment")]
    bad = []

    def work(i):
        for k in range(12):
            case = cases[(i + k) % len(cases)]
            got = TK.fill_sorted_runs(*runs_args(case, cuda))
            torch.cuda.synchronize()
            if not np.array_equal(got.cpu().numpy(), runs_ref(*case)):
                bad.append((i, k))

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not bad


@pytest.mark.cuda
def test_sorted_runs_refuse_a_mix_of_devices(cuda):
    i32 = torch.int32
    with pytest.raises(ValueError):
        TK.fill_sorted_runs(8, 0, torch.zeros(2, dtype=i32, device=cuda),
                            torch.ones(2, dtype=i32),
                            torch.tensor([0, 2], dtype=i32, device=cuda),
                            torch.ones(1, dtype=torch.uint8, device=cuda))
    with pytest.raises(ValueError):
        TK.concat_row_spans(torch.zeros(2, 4, dtype=torch.uint8, device=cuda),
                            torch.zeros(2, dtype=i32),
                            torch.ones(2, dtype=i32, device=cuda),
                            torch.zeros(2, dtype=i32, device=cuda), 8, 71)


def _same_as_plain(got, args, ref=None):
    want = TK.bucket_compact_plain(*args)
    for g, w, r in zip(got, want, ref if ref is not None else want):
        assert (g is None) == (w is None) == (r is None)
        if g is not None:
            assert torch.equal(g, w)
            if ref is not None:
                assert np.array_equal(g.cpu().numpy(), r)


@pytest.mark.cuda
@pytest.mark.parametrize("name", COMPACT_CASES)
def test_bucket_compact_edges(cuda, name):
    """bucket_compact against its plain version and compact_ref on
    chip_smoke's edge cases, placed by the tile of their form's route, one
    launch each; the past-wave cases hold more tiles than one wave of the
    route's blocks."""
    form = COMPACT_FORMS[name]
    tile = TK.compact_tile(*form)
    case = compact_case(name, tile, TK.compact_mask_switch())
    n = case[0].shape[0]
    if name in COMPACT_PAST_WAVE:
        assert -(-n // TK.compact_tile(*form, n)) > TK.compact_wave(*form,
                                                                    n) > 0
    if name.startswith("mask_switch"):  # the last small tiles, then larger
        assert (TK.compact_tile(*form, n) > tile) == name.endswith("+1")
    args = compact_args(case, cuda)
    before = TK.launches["bucket_compact"]
    got = TK.bucket_compact(*args)
    torch.cuda.synchronize()
    assert TK.launches["bucket_compact"] == before + 1
    _same_as_plain(got, args, compact_ref(*case))


@pytest.mark.cuda
@pytest.mark.parametrize("payload", [False, True])
@pytest.mark.parametrize("cap_kind", COMPACT_CAPS)
@pytest.mark.parametrize("nbuckets", [1, 2, 3, 4, 8, 9, 64])
@pytest.mark.parametrize("n", [1, 777, 100_003])
def test_bucket_compact_seeded(cuda, n, nbuckets, cap_kind, payload):
    """The CPU tests' seeded cases (tests/test_torch_compact.py) on the
    card: the kernel against its plain version and compact_ref, 8 buckets
    on the register route and 9 on the match route."""
    case = compact_seeded(n, nbuckets, cap_kind, payload)
    args = compact_args(case, cuda)
    _same_as_plain(TK.bucket_compact(*args), args, compact_ref(*case))


@pytest.mark.cuda
@pytest.mark.parametrize("index", range(len(COMPACT_CALLS)))
def test_bucket_compact_at_main_path_shapes(cuda, index):
    """At every call of one SE chunk of phase 4's corpus, as the device
    path makes them (chip_smoke.compact_shapes: the grouping, the quality
    stream's count >= 2, the N flags, the N stream's and the coordinates'
    count >= 2, the decode tokens): the kernel against its plain version,
    and its indices against the parent's sort of the same keys."""
    label, bucket, k, cap, fill, payload, parent = compact_shapes(cuda)[index]
    got = TK.bucket_compact(bucket, k, cap, fill, payload)
    _same_as_plain(got, (bucket, k, cap, fill, payload))
    sort = parent()
    if bucket.dtype != torch.bool:  # the grouping keys: bid << 24 | pos
        assert torch.equal(got[0], torch.where(sort < 2**31 - 1,
                                               sort & 0xFFFFFF, fill))
    elif payload is None:
        assert torch.equal(got[0], sort), label
    else:  # the keys and their payload
        keys, riding = sort
        assert torch.equal(got[0], keys[:cap])
        assert torch.equal(got[1], torch.where(keys[:cap] != fill,
                                               riding[:cap], 0))


@pytest.mark.cuda
@pytest.mark.parametrize("form", [(True, 1), (False, 4), (False, 8),
                                  (False, 9)])
def test_bucket_compact_device_kernels(cuda, form):
    """A call's device operations in a CUDA graph capture (chip_smoke's
    compact_traced): one kernel for a mask, two for ids up to 8 buckets,
    three (the match route) above, and no other operation."""
    (kernels,) = compact_traced([form], cuda)
    assert len(kernels) == (1 if form[0] else 2 if form[1] <= 8 else 3), \
        kernels


@pytest.mark.cuda
def test_captured_ops_sees_every_launch(cuda):
    """The means of the kernel-count checks: a capture of 300 launches
    in a row (torch's kernels and the package's in turns) lists each of
    them once, in order, and runs none of them."""
    x = torch.zeros(4096, dtype=torch.int32, device=cuda)
    case = compact_args(compact_seeded(1000, 1, "at", False), cuda)

    def calls():
        for _ in range(100):
            x.add_(1)
            TK.bucket_compact(*case)
            x.view(torch.uint8)[:4].zero_()

    ops = TK.captured_ops(calls)
    assert len(ops) == 300, ops
    assert all("compact" in op for op in ops[1::3]), ops[:6]
    torch.cuda.synchronize()
    assert int(x[1]) == 100  # the capture ran nothing, the warm-up once


@pytest.mark.cuda
def test_bucket_compact_back_to_back(cuda):
    """50 launches in a row on one stream, masks and ids in turn over
    several sizes, none synchronised: each equals its plain version, and
    the stream's status words are all zero again after them."""
    cases = [compact_seeded(n, k, cap, True)
             for n in (777, 100_003, 1_000_003)
             for k, cap in ((1, "at"), (4, "below"), (8, "past_n"))]
    got = []
    for i in range(50):
        args = compact_args(cases[i % len(cases)], cuda)
        got.append((args, TK.bucket_compact(*args)))
    torch.cuda.synchronize()
    for args, out in got:
        _same_as_plain(out, args)
    status = TK._status_words(cuda, torch.cuda.current_stream(cuda)
                              .cuda_stream, 1)
    assert int(torch.count_nonzero(status)) == 0


@pytest.mark.cuda
def test_bucket_compact_from_threads(cuda):
    """Calls from 8 threads at once on one stream, masks and ids in turn
    (another call's launches may fall between the two launches of a call
    with ids): each equals its plain version, and the stream's status
    words are all zero after them."""
    import threading

    cases = [compact_args(compact_seeded(n, k, "at", True), cuda)
             for n in (100_003, 1_000_003) for k in (1, 3, 4, 8, 9)]
    outs = [[] for _ in range(8)]

    def work(t):
        for i in range(20):
            j = (t + i) % len(cases)
            outs[t].append((j, TK.bucket_compact(*cases[j])))

    threads = [threading.Thread(target=work, args=(t,)) for t in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    torch.cuda.synchronize()
    for out in outs:
        assert len(out) == 20
        for j, got in out:
            _same_as_plain(got, cases[j])
    status = TK._status_words(cuda, torch.cuda.current_stream(cuda)
                              .cuda_stream, 1)
    assert int(torch.count_nonzero(status)) == 0


@pytest.mark.cuda
def test_bucket_compact_on_two_streams(cuda):
    """Launches on two streams at once, each with its own status words:
    each equals its plain version, and both buffers are zero after."""
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    cases = [compact_seeded(2_000_003, k, "at", True) for k in (1, 4)]
    args = [compact_args(c, cuda) for c in cases]
    torch.cuda.synchronize()
    outs = []
    for rep in range(4):
        for st, a in zip(streams, args if rep % 2 else args[::-1]):
            with torch.cuda.stream(st):
                outs.append((a, TK.bucket_compact(*a)))
    torch.cuda.synchronize()
    for a, out in outs:
        _same_as_plain(out, a)
    for st in streams:
        assert int(torch.count_nonzero(TK._status_words(
            cuda, st.cuda_stream, 1))) == 0


@pytest.mark.cuda
def test_bucket_compact_refuses_a_mix_of_devices(cuda):
    bucket = torch.zeros(8, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        TK.bucket_compact(bucket, 1, 8, 0, torch.zeros(8, dtype=torch.int32))


@pytest.mark.cuda
def test_fill_runs_refuses_a_mix_of_devices(cuda):
    out = torch.zeros(8, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        TK.fill_runs(out, torch.zeros(2, dtype=torch.int32), 1, 3)
