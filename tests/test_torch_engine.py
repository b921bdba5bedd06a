"""The port's engine and CLI (repaq_tpu_torch/codec/device_engine.py,
repaq_tpu_torch/cli.py) against the host engine and the reference
encoder's goldens.

On the CPU the engine runs with ``device="cpu"``: the same tensor code and
the kernels' plain versions. Its chunks must be byte-identical to
``repaq_tpu.codec.vectorized`` (following tests/test_device_engine.py) and
route as documented. The CLI's ``--engine device`` needs CUDA and must
fail without it."""

import gzip
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from repaq_tpu.codec import vectorized
from repaq_tpu.codec.blocks import ReadBlock, lens_to_offsets
from repaq_tpu.codec.oracle import FastqRead
from repaq_tpu.format.rfqz import RfqzReader
from repaq_tpu_torch import cli
from repaq_tpu_torch.codec.device_engine import (DeviceEngine,
                                                 make_engine_config)

from test_device_engine import _mk_block

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FX = os.path.join(REPO, "tests", "fixtures")


@pytest.fixture
def eng():
    return DeviceEngine("cpu", min_bases=0)


def _roundtrip(eng, header, block, chunk):
    back = eng.decode_chunk(header, chunk)
    want = vectorized.decode_chunk(header, chunk)
    for f in ("name_flat", "name_off", "seq_flat", "seq_off", "qual_flat",
              "strand_flat"):
        assert np.array_equal(getattr(back, f), getattr(want, f)), f
    assert np.array_equal(back.seq_flat, block.seq_flat)
    assert np.array_equal(back.qual_flat, block.qual_flat)


@pytest.mark.parametrize("illumina", [True, False])
@pytest.mark.parametrize("nfrac", [0.0, 0.001, 0.02])
def test_se_encode_decode_byte_identical(eng, illumina, nfrac):
    block = _mk_block(600, 101, seed=3, illumina=illumina, nfrac=nfrac)
    header = vectorized.make_header_se(block)
    got = eng.encode_chunk(header, block, False)
    assert got.to_bytes() == vectorized.encode_chunk(header, block,
                                                     False).to_bytes()
    _roundtrip(eng, header, block, got)
    assert eng.stats == {"device_chunks": 1, "host_chunks": 0,
                         "device_decodes": 1, "host_decodes": 0}


def test_se_escape_records(eng):
    """Quality chars outside the first chunk's palette."""
    header = vectorized.make_header_se(_mk_block(400, 80, seed=5))
    block = _mk_block(400, 80, seed=6, esc=True)
    got = eng.encode_chunk(header, block, False)
    assert got.to_bytes() == vectorized.encode_chunk(header, block,
                                                     False).to_bytes()
    _roundtrip(eng, header, block, got)
    assert eng.stats["device_chunks"] == eng.stats["device_decodes"] == 1


def test_ragged_se_on_device(eng):
    """Ragged SE chunks take the flat device path both ways."""
    rng = np.random.default_rng(51)
    reads = []
    for i in range(400):
        L = int(rng.integers(40, 160))
        seq = bytes(rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=L,
                               p=[0.24, 0.24, 0.24, 0.24, 0.04]))
        qual = bytes(rng.choice(np.frombuffer(b"FF:,#", np.uint8), size=L))
        reads.append(FastqRead(b"@SIM:1:F:2:1101:%d:%d 1:N:0:AT" % (i, i),
                               seq, b"+", qual))
    block = ReadBlock.from_reads(reads)
    header = vectorized.make_header_se(block)
    got = eng.encode_chunk(header, block, False)
    assert got.to_bytes() == vectorized.encode_chunk(header, block,
                                                     False).to_bytes()
    _roundtrip(eng, header, block, got)
    assert eng.stats["device_chunks"] == eng.stats["device_decodes"] == 1


def _ragged_pe_block():
    """An interleaved PE block with overlaps in which one pair's mates are
    shorter than the rest."""
    block = _mk_block(400, 90, seed=21, pe_overlap=0.5)
    lens = np.diff(block.seq_off).copy()
    lens[4:6] -= 7
    off = lens_to_offsets(lens)
    cut = [np.concatenate([flat[s: s + ln]
                           for s, ln in zip(block.seq_off[:-1], lens)])
           for flat in (block.seq_flat, block.qual_flat)]
    return ReadBlock(block.n, block.name_flat, block.name_off, cut[0], off,
                     block.strand_flat, block.strand_off, cut[1], off.copy())


def test_pe_interleaved_chunks_take_the_host_route(eng):
    """Interleaved PE chunks of ragged read lengths: the PE step works in a
    (reads, L) grid, so they take the host engine both ways."""
    block = _ragged_pe_block()
    header = vectorized.make_header_pe(block)
    a = vectorized.analyze_chunk(header, block, True)
    assert a.can_interleave and a.encode_overlap and not a.read_len_same
    got = eng.encode_chunk(header, block, True)
    assert got.to_bytes() == vectorized.encode_chunk(header, block,
                                                     True).to_bytes()
    back = eng.decode_chunk(header, got)
    assert np.array_equal(back.seq_flat, block.seq_flat)
    assert eng.stats == {"device_chunks": 0, "host_chunks": 1,
                         "device_decodes": 0, "host_decodes": 1}


def test_pe_interleaved_chunks_take_the_device_path(eng):
    block = _mk_block(600, 96, seed=7, pe_overlap=0.5)
    header = vectorized.make_header_pe(block)
    assert header.encode_pe_by_overlap()
    got = eng.encode_chunk(header, block, True)
    assert got.to_bytes() == vectorized.encode_chunk(header, block,
                                                     True).to_bytes()
    _roundtrip(eng, header, block, got)
    assert eng.stats == {"device_chunks": 1, "host_chunks": 0,
                         "device_decodes": 1, "host_decodes": 0}


def test_size_window_routes():
    """Chunks at the window's edge take the device, one base past it the
    host; both byte-identical."""
    eng = DeviceEngine("cpu", min_bases=20_000, max_bases=30_000)
    for block, key in ((_mk_block(300, 100, seed=42), "device_chunks"),
                       (_mk_block(301, 100, seed=42), "host_chunks"),
                       (_mk_block(199, 100, seed=42), "host_chunks")):
        header = vectorized.make_header_se(block)
        before = eng.stats[key]
        got = eng.encode_chunk(header, block, False)
        assert eng.stats[key] == before + 1
        assert got.to_bytes() == vectorized.encode_chunk(header, block,
                                                         False).to_bytes()


def test_64_bin_palette_takes_the_host_route(eng):
    """When the major qual doubles as the N qual, a by-column palette can
    hold 64 bins, one past the meta byte's 7-bit ids: host route, both
    ways."""
    block = _mk_block(400, 100, seed=9, nfrac=0.0)
    rng = np.random.default_rng(1)
    seq = block.seq_flat.copy()
    qual = rng.choice(np.arange(40, 103, dtype=np.uint8), size=seq.size)
    nmask = rng.random(seq.size) < 0.6
    seq[nmask] = ord("N")
    qual[nmask] = ord("#")
    block = ReadBlock(block.n, block.name_flat, block.name_off, seq,
                      block.seq_off, block.strand_flat, block.strand_off,
                      qual, block.qual_off)
    header = vectorized.make_header_se(block)
    assert header.encode_qual_by_col() and header.normal_qual_bins() == 64
    got = eng.encode_chunk(header, block, False)
    assert got.to_bytes() == vectorized.encode_chunk(header, block,
                                                     False).to_bytes()
    assert np.array_equal(eng.decode_chunk(header, got).qual_flat, qual)
    assert eng.stats == {"device_chunks": 0, "host_chunks": 1,
                         "device_decodes": 0, "host_decodes": 1}


def test_quality_stats_header_identical(eng):
    cases = [_mk_block(700, 120, seed=31, nfrac=0.02),
             _mk_block(700, 120, seed=32, nfrac=0.0),
             _mk_block(700, 120, seed=33, nfrac=0.0005)]
    for block in cases:
        want = vectorized.make_header_se(block)
        got = vectorized.make_header_se(block, stats_fn=eng.quality_stats)
        assert got.to_bytes() == want.to_bytes()
    # unique N qual with >= 100 Ns: the nBaseQual policy (no npos stream)
    block = _mk_block(800, 120, seed=35, nfrac=0.02)
    quals = block.qual_flat.copy()
    quals[quals == ord("#")] = ord(",")
    quals[block.seq_flat == ord("N")] = ord("#")
    block2 = ReadBlock(block.n, block.name_flat, block.name_off,
                       block.seq_flat, block.seq_off, block.strand_flat,
                       block.strand_off, quals, block.qual_off)
    want = vectorized.make_header_se(block2)
    assert not want.encode_n_pos()
    got = vectorized.make_header_se(block2, stats_fn=eng.quality_stats)
    assert got.to_bytes() == want.to_bytes()
    chunk = eng.encode_chunk(got, block2, False)
    _roundtrip(eng, got, block2, chunk)


@pytest.mark.parametrize("pe_overlap,nfrac", [(0.5, 0.01), (0.0, 0.0),
                                              (0.9, 0.0005)])
def test_quality_stats_header_identical_pe(eng, pe_overlap, nfrac):
    """The PE header through the device quality scan (the case of
    tests/test_device_engine.py:226-230): the port's make_header_pe with
    the engine's stats gives the JAX package's host header, its bytes and
    its support_interleaved."""
    from repaq_tpu_torch.codec import vectorized as tvec

    pe = _mk_block(600, 96, seed=34, pe_overlap=pe_overlap, nfrac=nfrac)
    want = vectorized.make_header_pe(pe)
    got = tvec.make_header_pe(pe, stats_fn=eng.quality_stats)
    assert got.to_bytes() == want.to_bytes()
    assert got.support_interleaved == want.support_interleaved
    assert eng.config().make_header_pe(pe).to_bytes() == want.to_bytes()


def test_concurrent_workers_share_one_engine(eng):
    """More threads than cores on one engine with a short switch interval:
    every chunk byte-identical and no count lost."""
    blocks = [_mk_block(150, 64, seed=60 + i, nfrac=0.01) for i in range(12)]
    header = vectorized.make_header_se(blocks[0])
    want = [vectorized.encode_chunk(header, b, False).to_bytes()
            for b in blocks]
    got = [None] * len(blocks)
    errors = []

    def work(i):
        try:
            got[i] = eng.encode_chunk(header, blocks[i], False).to_bytes()
            eng.decode_chunk(header, eng.encode_chunk(header, blocks[i],
                                                      False))
        except Exception as e:  # reported below, with the thread's index
            errors.append((i, e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(len(blocks))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    assert got == want
    assert eng.stats["device_chunks"] == 2 * len(blocks)
    assert eng.stats["device_decodes"] == len(blocks)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

SE_GOLDENS = [
    ("se_big", "se_big.ref.k100.rfq", ["-k", "100"]),
    ("se_illumina", "se_illumina.ref.rfq", []),
    ("se_varlen", "se_varlen.ref.rfq", []),
    ("se_fewn", "se_fewn.ref.k100.rfq", ["-k", "100"]),
    ("se_manyq", "se_manyq.ref.k100.rfq", ["-k", "100"]),
    ("se_nonl", "se_nonl.ref.rfq", []),
    ("se_crlf", "se_crlf.ref.rfq", []),
    ("se_bgi", "se_bgi.ref.rfq", []),
]


def _fastq(tmp_path, base):
    f = tmp_path / (base + ".fq")
    f.write_bytes(gzip.open(os.path.join(FX, base + ".fq.gz")).read())
    return f


@pytest.mark.parametrize("base,golden,extra", SE_GOLDENS)
@pytest.mark.parametrize("workers", ["1", "4"])
def test_cli_goldens_through_the_engine(tmp_path, monkeypatch, base, golden,
                                        extra, workers):
    """The port's CLI entry with its engine on the CPU device, forced onto
    the small fixtures by REPAQ_DEVICE_MIN_BASES=0: reference bytes out,
    input bytes back."""
    monkeypatch.setenv("REPAQ_DEVICE_MIN_BASES", "0")
    config = make_engine_config("cpu")
    eng = config.encode_chunk.__self__  # the DeviceEngine, for its stats
    assert eng.min_bases == 0
    fq = _fastq(tmp_path, base)
    out = tmp_path / "o.rfq"
    back = tmp_path / "b.fq"
    assert cli.main(["-c", "-i", str(fq), "-o", str(out), "-w", workers,
                     *extra], engine=config) == 0
    with open(os.path.join(FX, golden), "rb") as f:
        assert out.read_bytes() == f.read()
    assert cli.main(["-d", "-i", str(out), "-o", str(back), "-w", workers],
                    engine=config) == 0
    # the reference's decoder writes LF line ends for CRLF input
    assert back.read_bytes() == fq.read_bytes().replace(b"\r\n", b"\n")
    if base == "se_manyq":  # > 64 quality bins: not by-column, host route
        assert eng.stats["device_chunks"] == 0
    else:
        assert eng.stats["host_chunks"] == eng.stats["host_decodes"] == 0
        assert eng.stats["device_chunks"] == eng.stats["device_decodes"] > 0


@pytest.mark.parametrize("argv,item", [
    (["--mesh_devices", "2"], "A8"),
    (["--num_shards", "2", "--shard", "0", "--no_assemble"], "A10"),
    (["-o", "{tmp}/o.rfqz"], "A9"),
])
def test_cli_rejects_what_is_not_ported(tmp_path, capsys, monkeypatch, argv,
                                        item):
    """Every feature of repaq_tpu.cli is ported, and none is rejected as
    not ported. A9 (.rfqz output) is accepted, and the file reads back to
    the .rfq stream of the same chunking. A8 (--mesh_devices): without
    CUDA it exits non-zero for want of a device, not of a port, and on
    devices it runs (CPU devices stand in here). A10 (--num_shards): shard
    0 with --no_assemble writes its part, the same bytes as repaq_tpu's
    shard 0, and leaves the output to the assembly."""
    fq = _fastq(tmp_path, "se_illumina")
    argv = [a.replace("{tmp}", str(tmp_path)) for a in argv]
    if item == "A8":
        from repaq_tpu_torch.parallel import mesh_engine

        out = tmp_path / "o.rfq"
        monkeypatch.setattr(mesh_engine, "cuda_devices", lambda: [])
        with pytest.raises(SystemExit) as e:
            cli.main(["-c", "-i", str(fq), *argv, "-o", str(out)])
        err = capsys.readouterr().err
        assert e.value.code != 0 and "CUDA" in err
        assert "not ported" not in err and not out.exists()
        monkeypatch.setattr(mesh_engine, "cuda_devices", lambda: ["cpu"] * 2)
        assert cli.main(["-c", "-i", str(fq), *argv, "-o", str(out)]) == 0
        with open(os.path.join(FX, "se_illumina.ref.rfq"), "rb") as f:
            assert out.read_bytes() == f.read()
        return
    if item == "A9":
        rfq = tmp_path / "o.rfq"
        assert cli.main(["-c", "-i", str(fq), *argv, "--engine",
                         "vectorized"]) == 0
        assert cli.main(["-c", "-i", str(fq), "-o", str(rfq), "-k", "16000",
                         "--engine", "vectorized"]) == 0
        reader = RfqzReader(argv[1])
        assert reader.read() == rfq.read_bytes()
        reader.close()
        assert item not in capsys.readouterr().err
        return
    from repaq_tpu import pipeline as jpipeline
    from repaq_tpu.parallel import distributed as jdist

    out = tmp_path / "o.rfq"
    assert cli.main(["-c", "-i", str(fq), *argv, "-o", str(out), "--engine",
                     "vectorized"]) == 0
    assert "not ported" not in capsys.readouterr().err
    assert not out.exists()
    part = tmp_path / "o.rfq.part0"
    want = jdist.compress_se_distributed(
        str(fq), str(tmp_path / "j.rfq"), num_processes=2, process_id=0,
        engine=jpipeline.get_engine("vectorized"), assemble=False)
    with open(want, "rb") as f:
        assert part.read_bytes() == f.read()
    assert not (tmp_path / "o.rfq.part1").exists()


def test_cli_device_engine_needs_cuda_and_auto_goes_host(tmp_path):
    """Without CUDA, --engine device exits non-zero and writes nothing;
    auto runs the host engine, byte-identical to the reference. Also: the
    CLI and everything it imports leave jax out of sys.modules."""
    fq = _fastq(tmp_path, "se_illumina")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    env.pop("JAX_PLATFORMS", None)
    out = tmp_path / "dev.rfq"
    r = subprocess.run(
        [sys.executable, "-m", "repaq_tpu_torch.cli", "-c", "-i", str(fq),
         "-o", str(out), "--engine", "device"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert "CUDA" in r.stderr
    assert not out.exists()
    script = (
        "import sys, runpy\n"
        "import repaq_tpu_torch.cli, repaq_tpu_torch.codec.device_engine\n"
        "import repaq_tpu_torch.ops.device_streams\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "sys.argv = ['repaq_tpu_torch.cli', '-c', '-i', %r, '-o', %r]\n"
        "rc = repaq_tpu_torch.cli.main()\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "sys.exit(rc)\n" % (str(fq), str(tmp_path / "auto.rfq"))
    )
    r = subprocess.run([sys.executable, "-c", script], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    with open(os.path.join(FX, "se_illumina.ref.rfq"), "rb") as f:
        assert (tmp_path / "auto.rfq").read_bytes() == f.read()


def test_pipeline_get_engine_binds_the_card_when_cuda_is_there(monkeypatch):
    """The engine every pipeline entry point takes when the caller names
    none: 'auto' and 'device' bind the device engine on cuda:0 once torch
    sees CUDA, REPAQ_ENGINE pins 'auto', and 'device' without CUDA
    raises."""
    import torch

    from repaq_tpu_torch import pipeline
    from repaq_tpu_torch.codec import device_engine as TE

    bound = []

    def fake_config(device):
        bound.append(device)
        return pipeline.EngineConfig(None, None, None, None, name="device")

    monkeypatch.setattr(TE, "make_engine_config", fake_config)
    monkeypatch.delenv("REPAQ_ENGINE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert pipeline.get_engine().name == "device"
    assert pipeline.get_engine("device").name == "device"
    assert cli.get_engine("auto").name == "device"
    assert bound == ["cuda:0"] * 3
    monkeypatch.setenv("REPAQ_ENGINE", "vectorized")
    assert pipeline.get_engine().name == "vectorized"
    monkeypatch.delenv("REPAQ_ENGINE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pipeline.get_engine().name == "vectorized"
    assert pipeline.get_engine("oracle").name == "oracle"
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.get_engine("device")
    assert len(bound) == 3
