"""Byte-range sharding in the port (repaq_tpu_torch/parallel/distributed.py
and ``--num_shards`` in repaq_tpu_torch/cli.py) on the CPU, following
tests/test_distributed.py and tests/test_parallel.py's shard case.

Every plan (ChunkSpec, PairChunkSpec, RfqChunkSpec) and every part's
bytes are held to repaq_tpu.parallel.distributed's on the same inputs, and
the assembled output to the reference encoder's goldens or the serial
pipeline's bytes. Both packages run the host ``vectorized`` engine.
Everything is bytes or integers: the tolerance is exact equality."""

import dataclasses
import gzip
import io
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from repaq_tpu import pipeline as jpipeline
from repaq_tpu.parallel import distributed as JD
from repaq_tpu_torch import cli, pipeline
from repaq_tpu_torch.format.chunk import RfqChunk
from repaq_tpu_torch.format.header import RfqHeader
from repaq_tpu_torch.format.rfqz import RfqzReader
from repaq_tpu_torch.parallel import distributed as PD
from test_torch_reference import jax_native  # noqa: F401

# repaq_tpu's native code runs from its source built for this CPU
pytestmark = pytest.mark.usefixtures("jax_native")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FX = os.path.join(REPO, "tests", "fixtures")
HOST = pipeline.get_engine("vectorized")
JHOST = jpipeline.get_engine("vectorized")


def _golden(name):
    with open(os.path.join(FX, name), "rb") as f:
        return f.read()


def _specs(plan):
    return [dataclasses.astuple(s) for s in plan]


def _interleaved(fixtures_dir, tmp_path):
    """An interleaved stream built from the PE fixtures."""
    r1 = (fixtures_dir / "pe_big_R1.fq").read_bytes().splitlines(keepends=True)
    r2 = (fixtures_dir / "pe_big_R2.fq").read_bytes().splitlines(keepends=True)
    inter = tmp_path / "inter.fq"
    with open(inter, "wb") as f:
        for i in range(0, len(r1), 4):
            f.writelines(r1[i : i + 4])
            f.writelines(r2[i : i + 4])
    return str(inter)


def _shard_compress(d, engine, ins, out, k, nproc, interleaved=False):
    """Each rank's part bytes and the assembled file of module d's sharded
    compress, the ranks run one after another in this process."""
    pe = len(ins) == 2 or interleaved
    parts = []
    for pid in range(nproc):
        if pe:
            part = d.compress_pe_distributed(
                ins[0], ins[1] if len(ins) == 2 else "", out, chunk_size=k,
                num_processes=nproc, process_id=pid, engine=engine,
                assemble=False, interleaved=interleaved)
        else:
            part = d.compress_se_distributed(
                ins[0], out, chunk_size=k, num_processes=nproc,
                process_id=pid, engine=engine, assemble=False)
        with open(part, "rb") as f:
            parts.append(f.read())
    if pe:
        header = d.derive_header_pe(ins[0], ins[1] if len(ins) == 2 else "",
                                    k, engine, interleaved)
    else:
        header = d.derive_header(ins[0], k, engine)
    d.assemble_parts(out, header.to_bytes(), nproc,
                     rfqz=out.endswith(".rfqz"))
    with open(out, "rb") as f:
        return parts, f.read()


def _both(tmp_path, ins, name, k, nproc, interleaved=False):
    """The port's and repaq_tpu's sharded compress on the same inputs:
    parts equal rank by rank, and the port's assembled bytes returned."""
    (tmp_path / "port").mkdir(exist_ok=True)
    (tmp_path / "jax").mkdir(exist_ok=True)
    parts, got = _shard_compress(PD, HOST, ins, str(tmp_path / "port" / name),
                                 k, nproc, interleaved)
    jparts, want = _shard_compress(JD, JHOST, ins,
                                   str(tmp_path / "jax" / name), k, nproc,
                                   interleaved)
    assert parts == jparts
    assert got == want
    return got


PARTITIONS = {(10, 3): [(0, 4), (4, 7), (7, 10)],
              (2, 4): [(0, 1), (1, 2), (2, 2), (2, 2)]}


@pytest.mark.parametrize("n_chunks,n_processes", [
    (10, 3), (2, 4), (0, 2), (7, 1), (9, 9), (100, 7)])
def test_partition(n_chunks, n_processes):
    got = PD.partition(n_chunks, n_processes)
    assert got == JD.partition(n_chunks, n_processes)
    assert len(got) == n_processes and got[-1][1] == n_chunks
    if (n_chunks, n_processes) in PARTITIONS:
        assert got == PARTITIONS[n_chunks, n_processes]


@pytest.mark.parametrize("base,k", [
    ("se_big", 100_000), ("se_big", 10_000), ("se_big_nonl", 100_000),
    ("se_varlen", 10_000), ("se_crlf", 10_000)])
def test_plan_matches_serial_chunking(fixtures_dir, base, k):
    path = str(fixtures_dir / (base + ".fq"))
    plan = PD.plan_chunks(path, k)
    assert _specs(plan) == _specs(JD.plan_chunks(path, k))
    assert plan[0].byte_start == 0
    assert plan[-1].byte_end == os.path.getsize(path)
    for a, b in zip(plan, plan[1:]):
        assert a.byte_end == b.byte_start
    if (base, k) == ("se_big", 100_000):
        assert len(plan) == 3 and sum(p.n_reads for p in plan) == 3000


@pytest.mark.parametrize("interleaved", [False, True])
def test_pair_plan_contiguity(fixtures_dir, tmp_path, interleaved):
    r1, r2 = (str(fixtures_dir / "pe_big_R1.fq"),
              str(fixtures_dir / "pe_big_R2.fq"))
    if interleaved:
        r1, r2 = _interleaved(fixtures_dir, tmp_path), ""
    plan = PD.plan_pair_chunks(r1, r2, 100_000, interleaved)
    assert _specs(plan) == _specs(JD.plan_pair_chunks(r1, r2, 100_000,
                                                      interleaved))
    assert len(plan) > 1
    assert plan[0].byte_start1 == 0 and plan[0].byte_start2 == 0
    assert plan[-1].byte_end1 == os.path.getsize(r1)
    if not interleaved:
        assert plan[-1].byte_end2 == os.path.getsize(r2)
    for a, b in zip(plan, plan[1:]):
        assert a.byte_end1 == b.byte_start1
        assert a.byte_end2 == b.byte_start2


@pytest.mark.parametrize("nproc", [1, 2, 3])
@pytest.mark.parametrize("kind", ["se", "pe", "interleaved"])
def test_distributed_matches_golden(fixtures_dir, tmp_path, kind, nproc):
    if kind == "se":
        ins, golden = [str(fixtures_dir / "se_big.fq")], "se_big.ref.k100.rfq"
    else:
        ins, golden = ([str(fixtures_dir / "pe_big_R1.fq"),
                        str(fixtures_dir / "pe_big_R2.fq")],
                       "pe_big.ref.k100.rfq")
    if kind == "interleaved":
        ins = [_interleaved(fixtures_dir, tmp_path)]
    got = _both(tmp_path, ins, "dist.rfq", 100_000, nproc,
                interleaved=kind == "interleaved")
    assert got == _golden(golden)


@pytest.mark.parametrize("ins", [["se_nonl.fq"], ["pe_nl1.fq", "pe_nl2.fq"]])
def test_distributed_no_trailing_newline(fixtures_dir, tmp_path, ins):
    """Per-chunk flags come from the plan; a rank encoding only middle
    chunks must still set them exactly like the serial reader would."""
    ins = [str(fixtures_dir / f) for f in ins]
    got = _both(tmp_path, ins, "nl.rfq", 10_000, 2)
    serial = tmp_path / "serial.rfq"
    if len(ins) == 2:
        pipeline.compress_pe(ins[0], ins[1], str(serial), chunk_size=10_000,
                             engine=HOST)
    else:
        pipeline.compress_se(ins[0], str(serial), chunk_size=10_000,
                             engine=HOST)
    assert got == serial.read_bytes()


def test_shard_compress_verify_wired(tmp_path, monkeypatch):
    """--num_shards compress honours verify: the rank's _Compressor
    receives the flag and re-decodes each chunk."""
    f1 = tmp_path / "in.fq"
    f1.write_bytes(gzip.open(os.path.join(FX, "se_big.fq.gz")).read())
    calls = []
    real = pipeline._verify_chunk
    monkeypatch.setattr(pipeline, "_verify_chunk",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    out = tmp_path / "s.rfq"
    PD.compress_se_distributed(str(f1), str(out), chunk_size=10_000,
                               num_processes=1, process_id=0, engine=HOST,
                               verify=True)
    assert len(calls) >= 2, "verify not invoked on the shard path"
    serial = tmp_path / "serial.rfq"
    pipeline.compress_se(str(f1), str(serial), chunk_size=10_000,
                         engine=HOST)
    assert out.read_bytes() == serial.read_bytes()


def _run_ranks(argvs, timeout=240):
    """Every argv as its own `python -m repaq_tpu_torch.cli` process, all
    at once; each must exit 0."""
    env = dict(os.environ, PYTHONPATH=REPO, REPAQ_SHARD_STALL="120")
    procs = [subprocess.Popen([sys.executable, "-m", "repaq_tpu_torch.cli",
                               *argv], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for argv in argvs]
    try:
        errs = [p.communicate(timeout=timeout)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err.decode()[-2000:]


@pytest.mark.parametrize("pe", [False, True])
def test_distributed_separate_processes(fixtures_dir, tmp_path, pe):
    """Real OS processes through the CLI, like separate hosts sharing a
    filesystem: shard 0 waits for the parts and assembles them."""
    out = str(tmp_path / "proc.rfq")
    if pe:
        ins = ["-i", str(fixtures_dir / "pe_big_R1.fq"),
               "-I", str(fixtures_dir / "pe_big_R2.fq")]
    else:
        ins = ["-i", str(fixtures_dir / "se_big.fq")]
    _run_ranks([["-c", *ins, "-o", out, "-k", "100", "--engine",
                 "vectorized", "--num_shards", "2", "--shard", str(i)]
                for i in range(2)])
    assert open(out, "rb").read() == _golden(
        "pe_big.ref.k100.rfq" if pe else "se_big.ref.k100.rfq")
    assert not os.path.exists(out + ".part0")


def test_sharded_rfqz_compose(fixtures_dir, tmp_path):
    """--num_shards with a .rfqz target: per-rank bare section streams
    (host coder) concatenate under one container header. The file equals
    repaq_tpu.parallel.distributed's, its .rfq stream the golden, and it
    decodes to the input."""
    in1 = str(fixtures_dir / "se_big.fq")
    out = str(tmp_path / "s.rfqz")
    _run_ranks([["-c", "-i", in1, "-o", out, "-k", "100", "--num_shards",
                 "3", "--shard", str(i)] for i in range(3)])
    jout = str(tmp_path / "j.rfqz")
    _jparts, want = _shard_compress(JD, JHOST, [in1], jout, 100_000, 3)
    assert open(out, "rb").read() == want
    reader = RfqzReader(out)
    assert reader.read() == _golden("se_big.ref.k100.rfq")
    reader.close()
    back = str(tmp_path / "back.fq")
    assert cli.main(["-d", "-i", out, "-o", back]) == 0
    assert open(back, "rb").read() == open(in1, "rb").read()


@pytest.mark.parametrize("golden", ["se_big.ref.k100.rfq",
                                    "pe_big.ref.k100.rfq",
                                    "se_big_nonl.ref.k100.rfq"])
def test_plan_rfq_chunks(golden):
    """The metadata-only chunk index agrees with a full parse and with
    repaq_tpu's."""
    path = os.path.join(FX, golden)
    header, specs = PD.plan_rfq_chunks(path)
    jheader, jspecs = JD.plan_rfq_chunks(path)
    assert header.to_bytes() == jheader.to_bytes()
    assert _specs(specs) == _specs(jspecs)
    stream = io.BytesIO(_golden(golden))
    h2 = RfqHeader.read(stream)
    i = 0
    while True:
        off = stream.tell()
        c = RfqChunk.read(stream, h2)
        if c.reads == 0:
            break
        assert (specs[i].offset, specs[i].reads, specs[i].flags) == (
            off, c.reads, c.flags)
        i += 1
    assert i == len(specs) > 1


def _shard_decompress(d, engine, rfq, outs, nproc):
    parts = []
    for pid in range(nproc):
        d.decompress_distributed(rfq, outs[0], outs[1] if len(outs) > 1
                                 else "", num_processes=nproc,
                                 process_id=pid, engine=engine,
                                 assemble=False)
        for o in outs:
            with open("%s.part%d" % (o, pid), "rb") as f:
                parts.append(f.read())
    for o in outs:
        d.assemble_fastq_parts(o, nproc)
    return parts


@pytest.mark.parametrize("nproc", [1, 2, 3, 5])
@pytest.mark.parametrize("golden,fastqs", [
    ("se_big.ref.k100.rfq", ["se_big.fq"]),
    ("pe_big.ref.k100.rfq", ["pe_big_R1.fq", "pe_big_R2.fq"]),
    ("se_big_nonl.ref.k100.rfq", ["se_big_nonl.fq"])])
def test_decompress_distributed(fixtures_dir, tmp_path, golden, fastqs,
                                nproc):
    """Each rank decodes its chunk range; the final-chunk trim lands on the
    rank owning the last chunk. Parts equal repaq_tpu's, the assembled
    files the inputs."""
    rfq = os.path.join(FX, golden)
    outs = [str(tmp_path / ("p%d.fq" % m)) for m in range(len(fastqs))]
    jouts = [str(tmp_path / ("j%d.fq" % m)) for m in range(len(fastqs))]
    parts = _shard_decompress(PD, HOST, rfq, outs, nproc)
    assert parts == _shard_decompress(JD, JHOST, rfq, jouts, nproc)
    for o, fq in zip(outs, fastqs):
        assert open(o, "rb").read() == (fixtures_dir / fq).read_bytes()


@pytest.mark.parametrize("pe", [False, True])
def test_decompress_sharded_cli(fixtures_dir, tmp_path, pe):
    """End to end: -d --num_shards over real OS processes."""
    o1, o2 = str(tmp_path / "o1.fq"), str(tmp_path / "o2.fq")
    rfq = os.path.join(FX, "pe_big.ref.k100.rfq" if pe
                       else "se_big.ref.k100.rfq")
    outs = ["-o", o1] + (["-O", o2] if pe else [])
    _run_ranks([["-d", "-i", rfq, *outs, "--engine", "vectorized",
                 "--num_shards", "3", "--shard", str(i), "--workers", "2"]
                for i in range(3)])
    want = ["pe_big_R1.fq", "pe_big_R2.fq"] if pe else ["se_big.fq"]
    for o, fq in zip([o1, o2], want):
        assert open(o, "rb").read() == (fixtures_dir / fq).read_bytes()


def _run_sharded_plan(path, chunk_size, R):
    """plan_chunks_sharded on R threads joined by an all-gather stub."""
    results = [None] * R
    state = {"bufs": [None] * R, "out": None}
    barrier = threading.Barrier(R, timeout=60)

    def allgather_for(pid):
        def ag(vec):
            state["bufs"][pid] = np.asarray(vec, dtype=np.int64)
            barrier.wait()
            if pid == 0:
                state["out"] = np.stack(state["bufs"])
            barrier.wait()
            out = state["out"]
            barrier.wait()
            return out

        return ag

    def work(pid):
        results[pid] = PD.plan_chunks_sharded(path, chunk_size, R, pid,
                                              allgather_for(pid))

    ths = [threading.Thread(target=work, args=(p,)) for p in range(R)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=120)
        assert not t.is_alive()
    return results


@pytest.mark.parametrize("base", ["se_big", "se_big_nonl", "se_varlen"])
def test_plan_chunks_sharded_matches_replicated(fixtures_dir, base):
    """The rank-sharded plan (sharded newline scan + carry relay) equals
    the replicated plan of both packages exactly, on every rank, for any
    rank count, including the no-trailing-newline and variable-length
    files."""
    path = str(fixtures_dir / (base + ".fq"))
    for chunk_size in (10_000, 100_000):
        want = _specs(JD.plan_chunks(path, chunk_size))
        assert _specs(PD.plan_chunks(path, chunk_size)) == want
        for R in (1, 2, 3, 5):
            got = _run_sharded_plan(path, chunk_size, R)
            for pid in range(R):
                assert _specs(got[pid]) == want, (chunk_size, R, pid)


@pytest.mark.parametrize("data", [b"@r\r\nACGT\r\n+\r\nFFFF\r\n",
                                  b"@r\nACGT\n+\nFFFF\n\n"])
def test_plan_chunks_sharded_quirk_inputs_fall_back(tmp_path, data):
    """CRLF and empty-line files: every rank returns None (the replicated
    planner resolves them), collectively."""
    path = tmp_path / "q.fq"
    path.write_bytes(data)
    assert _run_sharded_plan(str(path), 10_000, 2) == [None, None]


@pytest.mark.parametrize("argv,msg", [
    (["--shard", "2"], "--shard must be in"),
    (["-o", "{tmp}/o.rfq.xz"], "requires a .rfq or .rfqz output"),
    (["-i", "{fx}/se_big.fq.gz"], "non-gz inputs"),
    (["-d", "-i", "{fx}/se_big.ref.k100.rfq", "-o", "{tmp}/o.fq.gz"],
     "plain (non-gz) FASTQ"),
])
def test_cli_shard_arguments_rejected(fixtures_dir, tmp_path, capsys, argv,
                                      msg):
    """The shard branches' own checks exit non-zero with repaq_tpu.cli's
    messages, writing no part."""
    argv = [a.replace("{tmp}", str(tmp_path)).replace("{fx}",
                                                      str(fixtures_dir))
            for a in argv]
    base = (["-c", "-i", str(fixtures_dir / "se_big.fq"), "-o",
             str(tmp_path / "o.rfq")] if "-d" not in argv else [])
    with pytest.raises(SystemExit) as e:
        cli.main([*base, *argv, "--num_shards", "2", "--engine",
                  "vectorized"])
    assert e.value.code != 0 and msg in capsys.readouterr().err
    assert not list(tmp_path.glob("*.part*"))


def test_cli_device_engine_with_shards_needs_cuda(fixtures_dir, tmp_path,
                                                  capsys, monkeypatch):
    """--engine device --num_shards without CUDA exits non-zero naming
    CUDA, and no shard runs on the host instead."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "o.rfq"
    with pytest.raises(SystemExit) as e:
        cli.main(["-c", "-i", str(fixtures_dir / "se_big.fq"), "-o",
                  str(out), "--engine", "device", "--num_shards", "2",
                  "--shard", "0", "--no_assemble"])
    assert e.value.code != 0 and "CUDA" in capsys.readouterr().err
    assert not list(tmp_path.glob("o.rfq*"))
