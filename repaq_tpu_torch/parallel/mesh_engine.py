"""Multi-GPU compress and decompress (``--mesh_devices``): the port of
repaq_tpu/parallel/mesh_engine.py, with its three entries and their
arguments.

The .rfq format's chunks are independent once the header is fixed, so the
device axis is pure data parallelism. One DeviceEngine runs on each
device, under the pipeline's ordered worker threads (at least one a
device): the k-th chunk call goes to engine k mod D. Headers come from
engine 0 alone. Every engine's chunks equal the host engine's, so the
output equals the serial pipeline's for any D, and ordered writes,
``verify`` and ``fast_verify`` are the pipeline's own.

The JAX version batches D chunks of one (reads, L) shape into one
shard_map dispatch, flushes what such a batch cannot take through a
single-device engine, and switches Pallas off inside shard_map. None of
that is needed here: each engine takes any chunk, with the single-device
engine's own host routes.

On one card the D engines share ``cuda:0`` and its default stream: the
run checks bytes, it does not scale.
"""

from __future__ import annotations

import threading

import torch

from .. import pipeline
from ..codec.device_engine import make_engine
from ..pipeline import EngineConfig


def cuda_devices() -> list:
    """Every CUDA device torch sees, as 'cuda:i'."""
    if not torch.cuda.is_available():
        return []
    return ["cuda:%d" % i for i in range(torch.cuda.device_count())]


class MeshEngine:
    """DeviceEngines on several devices behind one EngineConfig. The k-th
    encode_chunk or decode_chunk call goes to engine k mod D; the count
    takes a lock, so each engine gets its share whatever the threads'
    timing."""

    def __init__(self, devices):
        self.engines = [make_engine(d) for d in devices]
        self._lock = threading.Lock()
        self._calls = 0

    def _next(self):
        with self._lock:
            k = self._calls
            self._calls += 1
        return self.engines[k % len(self.engines)]

    def encode_chunk(self, header, block, is_pe=False):
        return self._next().encode_chunk(header, block, is_pe)

    def decode_chunk(self, header, chunk):
        return self._next().decode_chunk(header, chunk)

    def config(self) -> EngineConfig:
        first = self.engines[0].config()
        return EngineConfig(
            make_header_se=first.make_header_se,
            make_header_pe=first.make_header_pe,
            encode_chunk=self.encode_chunk,
            decode_chunk=self.decode_chunk,
            name="device",
        )

    def stats(self) -> dict:
        """Each engine's device and stats; read them after the run."""
        return {"devices": [str(e.device) for e in self.engines],
                "engines": [dict(e.stats) for e in self.engines]}


def _plan(devices, engine, workers: int):
    """(engine config, workers, stats function) of a run on `devices`
    (default: every CUDA device torch sees). With fewer than two devices
    and an engine given, the serial pipeline runs that engine, as the JAX
    entries do."""
    devices = list(devices) if devices else cuda_devices()
    if not devices:
        raise RuntimeError(
            "the mesh needs CUDA devices, and torch sees none (it runs on "
            "the CPU only where the caller names CPU devices)")
    if len(devices) < 2 and engine is not None:
        return engine, workers, lambda: {"devices": devices, "engines": []}
    mesh = MeshEngine(devices)
    return mesh.config(), max(workers, len(devices)), mesh.stats


def compress_se_mesh(in1: str, out1: str, chunk_size: int = 1_000_000,
                     engine: EngineConfig | None = None, out_stream=None,
                     devices=None, verify: bool = False,
                     fast_verify: bool = False, workers: int = 1) -> dict:
    """SE compress with chunks fanned over `devices`; bytes identical to
    pipeline.compress_se. Returns each engine's device and stats."""
    config, workers, stats = _plan(devices, engine, workers)
    pipeline.compress_se(in1, out1, chunk_size=chunk_size, verify=verify,
                         fast_verify=fast_verify, engine=config,
                         out_stream=out_stream, workers=workers)
    return stats()


def compress_pe_mesh(in1: str, in2: str, out1: str,
                     chunk_size: int = 1_000_000, interleaved: bool = False,
                     engine: EngineConfig | None = None, out_stream=None,
                     devices=None, verify: bool = False,
                     fast_verify: bool = False, workers: int = 1) -> dict:
    """PE compress with chunks fanned over `devices` (revcomp, overlap
    search and elision on every device); bytes identical to
    pipeline.compress_pe. Returns each engine's device and stats."""
    config, workers, stats = _plan(devices, engine, workers)
    pipeline.compress_pe(in1, in2, out1, chunk_size=chunk_size,
                         interleaved=interleaved, verify=verify,
                         fast_verify=fast_verify, engine=config,
                         out_stream=out_stream, workers=workers)
    return stats()


def decompress_se_mesh(in1: str, out1: str,
                       engine: EngineConfig | None = None, in_stream=None,
                       devices=None, out2: str = "",
                       workers: int = 1) -> dict:
    """Decompress with chunk decode fanned over `devices`; bytes identical
    to pipeline.decompress. With out2, a PE container's reads split into
    out1/out2 as pipeline.decompress_pe does (an SE container then raises
    its "single-end" RfqFormatError). Returns each engine's device and
    stats."""
    config, workers, stats = _plan(devices, engine, workers)
    if out2:
        pipeline.decompress_pe(in1, out1, out2, engine=config,
                               in_stream=in_stream, workers=workers)
    else:
        pipeline.decompress(in1, out1, engine=config, in_stream=in_stream,
                            workers=workers)
    return stats()
