"""The torch.distributed transport (repaq_tpu_torch/parallel/torchdist.py)
on the CPU, following tests/test_jaxdist.py: gloo process groups of OS
processes joined by a ``file://`` rendezvous, every rank encoding its
chunk range in memory and the parts gathered in rank order to rank 0.
The writer's file must equal the reference encoder's golden bytes, or the
JAX package's serial compress where no golden has the chunk size (exact
equality)."""

import datetime
import gzip
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as tdist

from repaq_tpu import pipeline as jpipeline
from repaq_tpu_torch import pipeline
from repaq_tpu_torch.format.header import RfqHeader
from repaq_tpu_torch.parallel import torchdist as T
from test_torch_reference import jax_native  # noqa: F401

# repaq_tpu's native code runs from its source built for this CPU
pytestmark = pytest.mark.usefixtures("jax_native")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FX = os.path.join(REPO, "tests", "fixtures")
TIMINGS = {"encode_s", "sync_s", "gather_s", "part_bytes", "rounds",
           "copy_s"}

# argv: rendezvous (init_method, or "caller:<url>" for a group the worker
# makes itself), world size, rank, SE/PE/interleaved, in1, in2, out1,
# chunk size, slab bytes (0: the module's). Prints the rank's timings.
_WORKER = r"""
import datetime, json, sys
import torch.distributed as tdist
from repaq_tpu_torch import pipeline
from repaq_tpu_torch.parallel import torchdist as T

rdv, nproc, pid, mode, in1, in2, out1, k, slab = sys.argv[1:10]
nproc, pid = int(nproc), int(pid)
if int(slab):
    T._SLAB = int(slab)
timings = {}
kw = dict(in2=in2, chunk_size=int(k), is_pe=mode != "se",
          interleaved=mode == "interleaved",
          engine=pipeline.get_engine("vectorized"), timings=timings)
if rdv.startswith("caller:"):
    tdist.init_process_group("gloo", init_method=rdv[7:], world_size=nproc,
                             rank=pid, timeout=datetime.timedelta(seconds=60))
    T.compress_distributed_torch(in1, out1, **kw)
    tdist.destroy_process_group()
else:
    T.compress_distributed_torch(in1, out1, init_method=rdv, backend="gloo",
                                 num_processes=nproc, process_id=pid, **kw)
print(json.dumps(timings))
"""


def _gunzip(name, tmp_path):
    dst = tmp_path / name[:-3]
    dst.write_bytes(gzip.open(os.path.join(FX, name)).read())
    return str(dst)


def _golden(name):
    with open(os.path.join(FX, name), "rb") as f:
        return f.read()


def _run_group(tmp_path, mode, in1, in2, nproc, k=100_000, slab=0,
               caller=False):
    """One gloo group of nproc worker processes; each rank's timings."""
    out = str(tmp_path / "out.rfq")
    url = "file://" + str(tmp_path / "rendezvous")
    rdv = "caller:" + url if caller else url
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, rdv, str(nproc), str(pid), mode,
         in1, in2, out, str(k), str(slab)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for pid in range(nproc)]
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_o, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-2000:]
    timings = [json.loads(o.decode().strip().splitlines()[-1])
               for o, _e in outs]
    with open(out, "rb") as f:
        return f.read(), timings


@pytest.mark.parametrize("mode", ["se", "pe", "interleaved"])
def test_two_process_golden(tmp_path, mode):
    if mode == "se":
        in1, in2 = _gunzip("se_big.fq.gz", tmp_path), ""
    else:
        in1 = _gunzip("pe_big_R1.fq.gz", tmp_path)
        in2 = _gunzip("pe_big_R2.fq.gz", tmp_path)
    if mode == "interleaved":
        r1 = open(in1, "rb").read().splitlines(keepends=True)
        r2 = open(in2, "rb").read().splitlines(keepends=True)
        in1, in2 = str(tmp_path / "inter.fq"), ""
        with open(in1, "wb") as f:
            for i in range(0, len(r1), 4):
                f.writelines(r1[i : i + 4] + r2[i : i + 4])
    got, timings = _run_group(tmp_path, mode, in1, in2, 2)
    assert got == _golden("se_big.ref.k100.rfq" if mode == "se"
                          else "pe_big.ref.k100.rfq")
    header = RfqHeader.read(io.BytesIO(got)).to_bytes()
    assert sum(t["part_bytes"] for t in timings) == len(got) - len(header)
    for t in timings:
        assert set(t) == TIMINGS and t["rounds"] == 1


def test_three_process_uneven_split(tmp_path):
    """A rank count that does not divide the chunk count (8 chunks over
    3 ranks: 3, 3 and 2), on a group the caller made, with a 4 KB slab so
    that the gather runs many rounds and the writer seeks each rank's
    bytes to their place. Bytes equal the JAX package's serial compress
    at the same chunk size (exact equality)."""
    in1 = _gunzip("se_big.fq.gz", tmp_path)
    got, timings = _run_group(tmp_path, "se", in1, "", 3, k=40_000,
                              slab=4096, caller=True)
    serial = tmp_path / "serial.rfq"
    jpipeline.compress_se(in1, str(serial), chunk_size=40_000,
                          engine=jpipeline.get_engine("vectorized"))
    assert got == serial.read_bytes()
    lens = [t["part_bytes"] for t in timings]
    assert lens[0] > lens[2] > 0
    assert {t["rounds"] for t in timings} == {-(-max(lens) // 4096)}
    assert timings[0]["rounds"] > 3


def test_nccl_without_cuda_raises(tmp_path, monkeypatch):
    """backend='nccl' (the default) needs CUDA: without it the call raises
    before any rendezvous and leaves no process group behind."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    in1 = _gunzip("se_big.fq.gz", tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.compress_distributed_torch(
            in1, str(tmp_path / "o.rfq"), chunk_size=100_000,
            engine=pipeline.get_engine("vectorized"),
            init_method="file://" + str(tmp_path / "rdv"), num_processes=1,
            process_id=0)
    assert not tdist.is_initialized()
    assert not (tmp_path / "o.rfq").exists()


def test_one_process_gather_and_allgather(tmp_path, monkeypatch):
    """In a one-rank gloo group: the all-gather gives (1, k) int64, and the
    slab gather writes a part that spans several slabs, tail included, in
    order."""
    monkeypatch.setattr(T, "_SLAB", 1000)
    tdist.init_process_group(
        "gloo", init_method="file://" + str(tmp_path / "rdv"), world_size=1,
        rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        got = T._allgather(np.array([3, -1, 1 << 40], dtype=np.int64))
        assert got.dtype == np.int64 and got.tolist() == [[3, -1, 1 << 40]]
        part = np.random.default_rng(7).integers(
            0, 256, size=4321, dtype=np.uint8).tobytes()
        timings = {}
        with open(tmp_path / "w.bin", "w+b") as buf:
            assert T.gather_parts_ordered(part, 1, 0, buf,
                                          timings) == len(part)
            buf.seek(0)
            assert buf.read() == part and timings["rounds"] == 5
    finally:
        tdist.destroy_process_group()
