"""The port's multi-GPU path (repaq_tpu_torch/parallel/mesh_engine.py and
``--mesh_devices`` in repaq_tpu_torch/cli.py) on the CPU, following
tests/test_parallel.py's mesh cases.

The entries run here only where the caller names CPU devices:
``devices=["cpu"] * D`` for D = 2 and 3, one DeviceEngine each with the
kernels' plain versions, REPAQ_DEVICE_MIN_BASES=0 so the small fixtures
take the device path. Output must equal the reference encoder's goldens,
the serial pipeline's bytes and the JAX mesh's; every engine must have
coded chunks. Everything is bytes: the tolerance is exact equality."""

import gzip
import os
import sys
import threading

import numpy as np
import pytest

from repaq_tpu.parallel import mesh_engine as jmesh
from repaq_tpu_torch import cli, pipeline
from repaq_tpu_torch.codec import vectorized
from repaq_tpu_torch.format.header import RfqFormatError
from repaq_tpu_torch.parallel import mesh_engine as M

from test_device_engine import _mk_block
from test_torch_reference import jax_native  # noqa: F401

# repaq_tpu's native code runs from its source built for this CPU
pytestmark = pytest.mark.usefixtures("jax_native")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FX = os.path.join(REPO, "tests", "fixtures")
HOST = pipeline.get_engine("vectorized")

SE_GOLDENS = ["se_big.ref.k100.rfq", "se_big_nonl.ref.k100.rfq",
              "se_illumina.ref.rfq", "se_varlen.ref.rfq",
              "se_fewn.ref.k100.rfq", "se_manyq.ref.k100.rfq",
              "se_nonl.ref.rfq", "se_crlf.ref.rfq", "se_bgi.ref.rfq"]
PE_GOLDENS = ["pe_big.ref.k100.rfq", "pe_nl.ref.rfq", "pe_nov.ref.rfq",
              "pe.ref.rfq"]


@pytest.fixture(autouse=True)
def device_path_for_small_inputs(monkeypatch):
    monkeypatch.setenv("REPAQ_DEVICE_MIN_BASES", "0")


def _fastq(tmp_path, base):
    f = tmp_path / (base + ".fq")
    f.write_bytes(gzip.open(os.path.join(FX, base + ".fq.gz")).read())
    return f


def _golden(name):
    with open(os.path.join(FX, name), "rb") as f:
        return f.read()


def _every_engine(stats, key, d):
    assert stats["devices"] == ["cpu"] * d
    assert len(stats["engines"]) == d
    assert all(s[key] > 0 for s in stats["engines"]), stats


@pytest.mark.parametrize("d", [2, 3])
def test_mesh_compress_se_golden(tmp_path, d):
    fq = _fastq(tmp_path, "se_big")
    out = tmp_path / "m.rfq"
    stats = M.compress_se_mesh(str(fq), str(out), chunk_size=100_000,
                               devices=["cpu"] * d)
    assert out.read_bytes() == _golden("se_big.ref.k100.rfq")
    _every_engine(stats, "device_chunks", d)
    assert sum(s["host_chunks"] for s in stats["engines"]) == 0


def _mixed_fastq(tmp_path):
    """900 reads of 80 bp with a ragged run in the middle (reads
    300-329)."""
    rng = np.random.default_rng(3)
    recs = []
    for i in range(900):
        L = 80 if not (300 <= i < 330) else 50 + (i % 7)
        seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=L)
        qual = rng.choice(np.frombuffer(b"FFF:,#", np.uint8), size=L)
        recs.append(b"@r%d\n%s\n+\n%s\n" % (i, seq.tobytes(), qual.tobytes()))
    f = tmp_path / "mix.fq"
    f.write_bytes(b"".join(recs))
    return f


@pytest.mark.parametrize("d", [2, 3])
def test_mesh_compress_mixed_eligibility(tmp_path, monkeypatch, d):
    """A mid-file ragged chunk (the JAX mesh's fallback case, a device
    chunk here) and a last chunk under the size window (the engines' host
    route): bytes equal the serial pipeline's and the JAX mesh's, in
    order."""
    monkeypatch.setenv("REPAQ_DEVICE_MIN_BASES", "5000")
    f1 = _mixed_fastq(tmp_path)
    serial = tmp_path / "s.rfq"
    pipeline.compress_se(str(f1), str(serial), chunk_size=10_000,
                         engine=HOST)
    meshed = tmp_path / "m.rfq"
    stats = M.compress_se_mesh(str(f1), str(meshed), chunk_size=10_000,
                               devices=["cpu"] * d)
    assert meshed.read_bytes() == serial.read_bytes()
    _every_engine(stats, "device_chunks", d)
    assert sum(s["host_chunks"] for s in stats["engines"]) == 1
    jax_out = tmp_path / "j.rfq"
    jstats = jmesh.compress_se_mesh(str(f1), str(jax_out), chunk_size=10_000)
    assert jstats["fallback_chunks"] >= 1
    assert meshed.read_bytes() == jax_out.read_bytes()


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("rfq", SE_GOLDENS)
def test_mesh_decompress_se_matches_serial(tmp_path, rfq, d):
    """Every SE golden decodes to the serial decompress's bytes, the
    final chunk's trailing-newline trim included."""
    serial = tmp_path / "s.fq"
    pipeline.decompress(os.path.join(FX, rfq), str(serial), engine=HOST)
    meshed = tmp_path / "m.fq"
    stats = M.decompress_se_mesh(os.path.join(FX, rfq), str(meshed),
                                 devices=["cpu"] * d)
    assert meshed.read_bytes() == serial.read_bytes()
    if rfq.startswith("se_big"):  # 4 chunks: every engine decodes
        _every_engine(stats, "device_decodes", d)


@pytest.mark.parametrize("d", [2, 3])
def test_mesh_compress_pe_golden(tmp_path, d):
    f1, f2 = _fastq(tmp_path, "pe_big_R1"), _fastq(tmp_path, "pe_big_R2")
    out = tmp_path / "m.rfq"
    stats = M.compress_pe_mesh(str(f1), str(f2), str(out),
                               chunk_size=100_000, devices=["cpu"] * d)
    assert out.read_bytes() == _golden("pe_big.ref.k100.rfq")
    _every_engine(stats, "device_chunks", d)


@pytest.mark.parametrize("d", [2, 3])
def test_mesh_decompress_pe(tmp_path, d):
    """A PE container to one interleaved output, as the serial
    decompress writes it."""
    rfq = os.path.join(FX, "pe_big.ref.k100.rfq")
    serial = tmp_path / "s.fq"
    pipeline.decompress(rfq, str(serial), engine=HOST)
    meshed = tmp_path / "m.fq"
    stats = M.decompress_se_mesh(rfq, str(meshed), devices=["cpu"] * d)
    assert meshed.read_bytes() == serial.read_bytes()
    _every_engine(stats, "device_decodes", d)


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("rfq", PE_GOLDENS)
def test_mesh_decompress_pe_split(tmp_path, rfq, d):
    """-o R1 -O R2: even and odd reads into two outputs, equal to the
    serial decompress_pe's, the R1 and R2 trailing-newline flags
    included."""
    s1, s2 = tmp_path / "s1.fq", tmp_path / "s2.fq"
    pipeline.decompress_pe(os.path.join(FX, rfq), str(s1), str(s2),
                           engine=HOST)
    m1, m2 = tmp_path / "m1.fq", tmp_path / "m2.fq"
    stats = M.decompress_se_mesh(os.path.join(FX, rfq), str(m1),
                                 devices=["cpu"] * d, out2=str(m2))
    assert m1.read_bytes() == s1.read_bytes()
    assert m2.read_bytes() == s2.read_bytes()
    assert stats["engines"][0]["device_decodes"] > 0


def test_mesh_decompress_split_of_se_container_raises(tmp_path):
    with pytest.raises(RfqFormatError, match="single-end"):
        M.decompress_se_mesh(os.path.join(FX, "se_big.ref.k100.rfq"),
                             str(tmp_path / "x1.fq"), devices=["cpu"] * 2,
                             out2=str(tmp_path / "x2.fq"))


def _corrupting_second_engine(monkeypatch):
    """make_engine whose second engine flips the last quality byte of
    every chunk it encodes."""
    made = []
    real = M.make_engine

    def make(device):
        eng = real(device)
        made.append(eng)
        if len(made) == 2:
            encode = eng.encode_chunk

            def corrupt(header, block, is_pe=False):
                chunk = encode(header, block, is_pe)
                qb = bytearray(chunk.qual_buf)
                qb[-1] ^= 0x01
                chunk.qual_buf = bytes(qb)
                return chunk

            eng.encode_chunk = corrupt
        return eng

    monkeypatch.setattr(M, "make_engine", make)


def test_mesh_compress_verify_wired(tmp_path, monkeypatch, capsys):
    """--verify on the mesh: every emitted chunk is decoded again and held
    against its source block, and a chunk one engine corrupts is caught
    (the integrity message of the serial path, reference
    repaq.cpp:430-528)."""
    fq = _fastq(tmp_path, "se_big")
    calls = []
    real = pipeline._verify_chunk

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(pipeline, "_verify_chunk", counting)
    out = tmp_path / "v.rfq"
    M.compress_se_mesh(str(fq), str(out), chunk_size=10_000, verify=True,
                       devices=["cpu"] * 2)
    serial = tmp_path / "serial.rfq"
    pipeline.compress_se(str(fq), str(serial), chunk_size=10_000,
                         engine=HOST)
    assert len(calls) >= 2
    assert out.read_bytes() == serial.read_bytes()
    assert "integrity check failure" not in capsys.readouterr().err

    monkeypatch.setattr(pipeline, "_verify_chunk", real)
    _corrupting_second_engine(monkeypatch)
    M.compress_se_mesh(str(fq), str(tmp_path / "c.rfq"), chunk_size=10_000,
                       verify=True, devices=["cpu"] * 2)
    assert "integrity check failure" in capsys.readouterr().err


def test_mesh_engine_shares_calls_evenly_under_thread_churn():
    """More threads than cores on one MeshEngine with a short switch
    interval: every chunk byte-identical to the host engine's, and the
    call counter gives each engine exactly its share."""
    mesh = M.MeshEngine(["cpu"] * 3)
    blocks = [_mk_block(150, 64, seed=80 + i, nfrac=0.01) for i in range(12)]
    header = vectorized.make_header_se(blocks[0])
    want = [vectorized.encode_chunk(header, b, False).to_bytes()
            for b in blocks]
    got = [None] * len(blocks)
    errors = []

    def work(i):
        try:
            got[i] = mesh.encode_chunk(header, blocks[i], False).to_bytes()
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
    assert [s["device_chunks"] for s in mesh.stats()["engines"]] == [4] * 3


def test_mesh_devices_default_to_cuda_and_one_device_runs_serial(
        tmp_path, monkeypatch):
    """devices=None is every CUDA device torch sees, and with none the
    entries raise; one device with an engine given runs the serial
    pipeline on that engine, as the JAX entries do."""
    fq = _fastq(tmp_path, "se_illumina")
    monkeypatch.setattr(M, "cuda_devices", lambda: [])
    with pytest.raises(RuntimeError, match="CUDA"):
        M.compress_se_mesh(str(fq), str(tmp_path / "x.rfq"))
    out = tmp_path / "one.rfq"
    stats = M.compress_se_mesh(str(fq), str(out), engine=HOST,
                               devices=["cpu"])
    assert stats == {"devices": ["cpu"], "engines": []}
    assert out.read_bytes() == _golden("se_illumina.ref.rfq")


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def test_cli_mesh_devices_without_cuda_exits_nonzero(tmp_path, monkeypatch,
                                                      capsys):
    fq = _fastq(tmp_path, "se_illumina")
    out = tmp_path / "o.rfq"
    monkeypatch.setattr(M, "cuda_devices", lambda: [])
    with pytest.raises(SystemExit) as e:
        cli.main(["-c", "-i", str(fq), "-o", str(out), "--mesh_devices",
                  "-1"])
    assert e.value.code != 0
    assert "CUDA" in capsys.readouterr().err
    assert not out.exists()


@pytest.mark.parametrize("argv,engines", [
    (["--mesh_devices", "2"], 2), (["--mesh_devices", "-1"], 3),
    (["--mesh_devices", "5", "--verify"], 3)])
def test_cli_mesh_devices_goldens_both_ways(tmp_path, monkeypatch, argv,
                                            engines):
    """With torch's device list taken to be CPU devices, --mesh_devices n
    takes min(n, count) of them and -1 all: the SE and PE goldens' bytes
    out, the inputs back, every engine used."""
    monkeypatch.setattr(M, "cuda_devices", lambda: ["cpu"] * 3)
    made = []
    real = M.make_engine
    monkeypatch.setattr(M, "make_engine",
                        lambda d: made.append(real(d)) or made[-1])
    se = _fastq(tmp_path, "se_big")
    r1, r2 = _fastq(tmp_path, "pe_big_R1"), _fastq(tmp_path, "pe_big_R2")
    for ins, golden, outs in (
            ([str(se)], "se_big.ref.k100.rfq", ["-o", str(tmp_path / "b.fq")]),
            ([str(r1), "-I", str(r2)], "pe_big.ref.k100.rfq",
             ["-o", str(tmp_path / "b1.fq"), "-O", str(tmp_path / "b2.fq")])):
        made.clear()
        rfq = tmp_path / golden
        assert cli.main(["-c", "-i", *ins, "-o", str(rfq), "-k", "100",
                         *argv]) == 0
        assert rfq.read_bytes() == _golden(golden)
        assert len(made) == engines
        assert all(e.stats["device_chunks"] > 0 for e in made)
        assert cli.main(["-d", "-i", str(rfq), *outs, *argv]) == 0
        assert all(e.stats["device_decodes"] > 0 for e in made[engines:])
        backs = [outs[1]] + ([outs[3]] if len(outs) > 2 else [])
        for src, back in zip((se,) if len(backs) == 1 else (r1, r2), backs):
            assert open(back, "rb").read() == src.read_bytes()


def test_cli_num_shards_still_rejected_with_mesh(tmp_path, monkeypatch,
                                                 capsys):
    """--num_shards with --mesh_devices takes the shard branch, as
    repaq_tpu.cli does: no mesh engine is made, each shard runs the engine
    --engine names, and the assembled bytes equal the golden."""
    monkeypatch.setattr(M, "cuda_devices", lambda: ["cpu"] * 2)
    made = []
    monkeypatch.setattr(M, "make_engine", lambda d: made.append(d))
    fq = _fastq(tmp_path, "se_big")
    out = tmp_path / "o.rfq"
    for shard in (1, 0):  # shard 0 assembles once both parts exist
        assert cli.main(["-c", "-i", str(fq), "-o", str(out), "-k", "100",
                         "--engine", "vectorized", "--mesh_devices", "2",
                         "--num_shards", "2", "--shard", str(shard)]) == 0
    assert out.read_bytes() == _golden("se_big.ref.k100.rfq")
    assert made == [] and "ERROR" not in capsys.readouterr().err
    assert not list(tmp_path.glob("o.rfq.part*"))
