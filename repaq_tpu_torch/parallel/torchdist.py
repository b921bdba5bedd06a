"""Multi-process compression over a torch.distributed process group: the
port of repaq_tpu/parallel/jaxdist.py (``compress_distributed_jax``).

This is the collective transport for the byte-range sharding mechanism in
parallel/distributed.py: instead of part FILES on a shared filesystem,
every process encodes its contiguous chunk range in memory and the
variable-length encoded bytes travel to the writer process over the
process group with an ORDERED gather. Rank order equals chunk order, so
the writer emits header + parts in gather order and the output is
byte-identical to the serial pipeline.

Design (the reference's single-writer container, main.cpp:134-159, with
the pipeline's no-communication header rule):
- no header broadcast: the header is a pure function of chunk 1, and each
  rank recomputes it bit-identically (distributed.derive_header);
- the only collectives are the all-gathers of the rank-sharded SE plan
  (``distributed.plan_chunks_sharded``), one all-gather of the part
  LENGTHS, and slab-wise all-gathers of the padded part payloads, so
  memory stays O(ranks x _SLAB) whatever the part size;
- fail-fast: any rank's exception ends the job (reference error_exit
  semantics).

Under NCCL the transport tensors live on ``torch.cuda.current_device()``
(a launcher gives each rank its card through CUDA_VISIBLE_DEVICES); under
gloo they live on the CPU. The codec engine is the caller's or
``pipeline.get_engine()``'s, whatever the backend.
"""

from __future__ import annotations

import io as _io
import time as _time

import numpy as np
import torch
import torch.distributed as tdist

from ..pipeline import EngineConfig, get_engine
from . import distributed as dist

_SLAB = 8 << 20  # per-round gather payload per process


def _device() -> torch.device:
    """Where the group's collectives take their tensors."""
    if tdist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _allgather_tensor(t: torch.Tensor) -> list[torch.Tensor]:
    out = [torch.empty_like(t) for _ in range(tdist.get_world_size())]
    tdist.all_gather(out, t)
    return out


def _allgather(arr: np.ndarray) -> np.ndarray:
    """numpy int64 (k,) from every rank -> (R, k) on every rank: the
    all-gather that plan_chunks_sharded takes."""
    t = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int64))
    return torch.stack(_allgather_tensor(t.to(_device()))).cpu().numpy()


def _encode_my_part(
    in1: str,
    in2: str,
    chunk_size: int,
    num_processes: int,
    process_id: int,
    engine: EngineConfig,
    is_pe: bool,
    interleaved: bool,
    workers: int,
) -> tuple[bytes, bytes]:
    """(header_bytes, my encoded part bytes): local work. The SE plan is
    rank-sharded over the process group (each rank scans ~1/R of the
    bytes), with the replicated planner as the quirk-input fallback."""
    if is_pe:
        plan = dist.plan_pair_chunks(in1, in2, chunk_size, interleaved)
        header = dist.derive_header_pe(in1, in2, chunk_size, engine,
                                       interleaved)
    else:
        plan = None
        if num_processes > 1:
            plan = dist.plan_chunks_sharded(
                in1, chunk_size, num_processes, process_id, _allgather,
            )
        if plan is None:
            plan = dist.plan_chunks(in1, chunk_size)
        header = dist.derive_header(in1, chunk_size, engine)
    header_bytes = header.to_bytes()
    lo, hi = dist.partition(len(plan), num_processes)[process_id]
    buf = _io.BytesIO()
    if is_pe:
        dist.encode_pair_chunk_range(
            in1, in2, plan, lo, hi, header, header_bytes, buf, engine,
            workers, interleaved,
        )
    else:
        dist.encode_chunk_range(
            in1, plan, lo, hi, header, header_bytes, buf, engine,
            chunk_size, workers,
        )
    return header_bytes, buf.getvalue()


def gather_parts_ordered(part: bytes, num_processes: int,
                         process_id: int, out=None,
                         timings: dict | None = None) -> int:
    """All ranks contribute their part; rank 0 writes them to ``out`` in
    rank order. Slab-wise, so peak memory is O(num_processes * _SLAB),
    not O(total). Returns the total bytes written (0 on non-writer ranks).

    ``timings`` (optional dict) receives ``rounds``, the slab rounds, and
    ``copy_s``, the seconds of this rank's host-to-device uploads and
    device-to-host downloads of the slabs (pageable copies under NCCL)."""
    dev = _device()
    lens = _allgather(np.array([len(part)], dtype=np.int64)).reshape(-1)
    max_len = int(lens.max())
    total = 0
    rounds = max(1, (max_len + _SLAB - 1) // _SLAB)
    copy_s = 0.0
    mv = memoryview(part)
    for r in range(rounds):
        s = r * _SLAB
        slab = np.zeros(_SLAB, dtype=np.uint8)
        piece = mv[s : s + _SLAB]
        if len(piece):
            slab[: len(piece)] = np.frombuffer(piece, dtype=np.uint8)
        t0 = _time.perf_counter()
        slab_t = torch.from_numpy(slab).to(dev)
        copy_s += _time.perf_counter() - t0
        gathered = _allgather_tensor(slab_t)
        if dev.type == "cuda":
            # the downloads below would wait for the collective: keep that
            # wait out of copy_s
            torch.cuda.synchronize(dev)
        if process_id == 0 and out is not None:
            for pid in range(num_processes):
                take = min(max(int(lens[pid]) - s, 0), _SLAB)
                if take:
                    t0 = _time.perf_counter()
                    data = gathered[pid][:take].cpu().numpy().tobytes()
                    copy_s += _time.perf_counter() - t0
                    # parts are streamed rank-major per slab round; the
                    # writer seeks so rank order == byte order
                    out.seek(int(lens[:pid].sum()) + s)
                    out.write(data)
                    total += take
    if timings is not None:
        timings["rounds"] = rounds
        timings["copy_s"] = copy_s
    return total


def compress_distributed_torch(
    in1: str,
    out1: str,
    in2: str = "",
    chunk_size: int = 1_000_000,
    engine: EngineConfig | None = None,
    is_pe: bool = False,
    interleaved: bool = False,
    workers: int = 1,
    init_method: str | None = None,
    backend: str = "nccl",
    num_processes: int | None = None,
    process_id: int | None = None,
    timings: dict | None = None,
) -> None:
    """Full multi-process compress with a torch.distributed transport.

    With ``init_method`` (a ``tcp://`` or ``file://`` URL), this call
    initialises the process group of ``backend`` with ``num_processes``
    and ``process_id`` and destroys it before returning; otherwise it runs
    on the group the caller made, whose backend it uses. NCCL needs CUDA
    and raises without it. Rank 0 writes ``out1``; other ranks write nothing.
    ``timings`` (optional dict) receives the phase split: ``encode_s``
    (plan + encode), ``sync_s`` (the barrier that absorbs rank skew),
    ``gather_s``, ``part_bytes``, and the gather's ``rounds`` and
    ``copy_s``.
    """
    if init_method is None:
        backend = tdist.get_backend()
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError(
            "backend 'nccl' needs CUDA, and torch sees no CUDA device "
            "(name backend='gloo' for a CPU process group)")
    if init_method is not None:
        tdist.init_process_group(backend, init_method=init_method,
                                 world_size=num_processes, rank=process_id)
    try:
        num_processes = num_processes or tdist.get_world_size()
        process_id = (process_id if process_id is not None
                      else tdist.get_rank())
        engine = engine or get_engine()

        t0 = _time.perf_counter()
        header_bytes, part = _encode_my_part(
            in1, in2, chunk_size, num_processes, process_id, engine, is_pe,
            interleaved, workers,
        )
        if timings is not None:
            timings["encode_s"] = _time.perf_counter() - t0
            timings["part_bytes"] = len(part)
            # separate rank-skew wait from transport: the first collective
            # blocks until the slowest rank arrives, so it would otherwise
            # be booked as gather time
            t0 = _time.perf_counter()
            if backend == "nccl":
                tdist.barrier(device_ids=[torch.cuda.current_device()])
            else:
                tdist.barrier()
            timings["sync_s"] = _time.perf_counter() - t0
            t0 = _time.perf_counter()
        if process_id == 0:
            with open(out1, "wb") as f:
                f.write(header_bytes)
                base = len(header_bytes)

                class _Shifted:
                    """File view whose offset 0 is the end of the header."""

                    def seek(self, pos):
                        f.seek(base + pos)

                    def write(self, b):
                        return f.write(b)

                gather_parts_ordered(part, num_processes, 0, _Shifted(),
                                     timings)
        else:
            gather_parts_ordered(part, num_processes, process_id, None,
                                 timings)
        if timings is not None:
            timings["gather_s"] = _time.perf_counter() - t0
    finally:
        if init_method is not None:
            tdist.destroy_process_group()
