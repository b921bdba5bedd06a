#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (repaq_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which must pass:
  1. device: the card's name and power limit, the torch and CUDA versions,
     the build of the port's native host library from
     repaq_tpu_torch/native/ (it must build and load; the compiler's
     message otherwise) and of the CUDA kernels from repaq_tpu_torch/csrc/
     (one nvcc per source, in parallel);
  2. kernels: each CUDA kernel against its plain torch version on the card
     at the shapes its path gives it (12 Mbase for the SE path, the PE
     path's 14,745,600-base padded chunk for the frontend on the PE path
     and the byte form; for the rANS kernels the CLI's largest order-1
     section, 2,285,523 bytes in 2048 lanes, and a 16 MB order-0 section
     in 4096 lanes, both with ragged lanes and held against the host
     coder's section bytes too; rans_encode also on an order-1 section of
     uniform random bytes, where all 65,536 contexts are live, and on 27
     staging edge cases, RANS_CASES; rans_layout also on the edges of its
     tiles, LAYOUT_CASES, placed by the built tile, one launch each, and
     the payload's zero fill timed alone at both sections; rans_decode
     through its wrapper, with the live contexts counted on the host as
     decode_section_device counts them, its table packing timed alone, and
     on 31 edge cases, DECODE_CASES, placed by the built window and shared
     limit, one launch each, against its plain version and the data, the
     route each took counted), exact
     equality, both timed with CUDA
     events (median of 15 runs, L2 flushed before each; the rANS kernels'
     plain versions, a Python loop over the steps, median of 3), each
     beside its bound: the bytes it must move over 3.35 TB/s. The token
     FSM also at n = 1, tile - 1, tile, tile + 1 and past 3,000 tiles
     (forced restarts at tile starts, all 4-byte tokens, tokens across
     tile edges; uint8 and int32 lengths), timed with both length types;
     the frontend also at n % 4 = 1, 2, 3 with 'N' and the major qual in
     the tail; the unpack also at m = 0, 1, 15, 16, 17 and 4109 (every
     tail of its words and of a thread's four words) and into the
     a buffer one byte longer; the pack and the byte-form frontend
     also on FRONT_CASES (every byte value at every position of a 16-byte
     group, n = 63, 64, 65, one wave's bases and one either side, a view
     one byte off alignment, 2^24 + 5 bases, the PE chunk), one launch
     each, and the byte form captured in a CUDA graph as one kernel a
     call; these three streaming kernels (unpack, pack, byte form) also
     timed at 16 units (the fixed cost of one event-timed launch), at 32
     Mi units, back to back over 8 buffer sets and once after a flush
     that leaves no dirty line in the L2. The run-boundary kernels (run_offsets on encode,
     seg_positions on decode) at a whole chunk's 11,829,248 elements and
     run_offsets at (2, 80000) coordinate rows, and both at n = 1,
     tile - 1, tile, tile + 1, 3 tiles + 5 and past 3,000 tiles
     (run_offsets 1-D and as 2 rows) on every RUN_KINDS and SEG_KINDS
     input: runs of 31-33 at the edges of steps, warps and tiles, a run of
     three tiles, segment starts at the first element only, everywhere
     and nowhere. The overlap search (overlap_pairs) on every
     OVERLAP_CASES input (L1 != L2 both ways, minlen 11, 12 and 13, o = 12
     and o = minlen, both directions in one pair, rows of one byte, bytes
     0 and 255, periodic rows, near misses), as given and as strided
     views, and at a PE chunk's grid, 49,152 pairs of 150 bytes, read as
     the engine reads it (the odd and even rows of one buffer), timed (the
     search alone is on no main path: pe_encode_pairs runs it). The PE
     pair tiles, pe_encode_pairs (the odd rows' revcomp, the search and
     the shift clamp, in place) and pe_decode_rows (the overlap expansion,
     N restore, revcomp and payload), on every PAIR_CASES and
     PAIR_LONG_CASES case placed by the built tile (pad rows, odd pair
     counts, clamps at +-127 and +-128, whole-row overlaps, L of 11-13,
     37, 1,000, 5,000, 20,000, 40,000 and 65,535, every byte value, no
     search, the nBaseQual restore; each grid decoded as encoded, with nbq
     ':' and once with wild tables), one launch each, against their plain
     versions and the cases' reads; then at one real PE chunk's calls
     recorded through repaq_tpu_torch.cli.main (pe_chunk_calls), each one
     device kernel a call in a CUDA graph capture (pairs_traced), exact and
     timed beside its bound (pairs_moved, rows_moved), its plain version
     and, in turns, the parent's torch composition (parent_pe_encode,
     parent_pe_decode).
     The decode's masked run writes (fill_runs) on every FILL_CASES case
     in uint8, bool and int32 (against its plain version and a numpy
     loop), then at one SE decode chunk's quality writes (FILL_CHUNK:
     2,359,296 entries, 1,680,349 with a count, 9,604 runs of 2; no keep,
     as the decode passes none), timed beside its bound, beside index_put_ of the same writes as distinct indices,
     and in turns beside the parent's composition of them (the token
     index_put_ and the 73,138,176-entry run grid aimed at a dump byte),
     and at that chunk's modeled N deltas and N bases, then at every
     fill_runs call of one real SE chunk recorded through cli.main (the
     encode's three layout writes, the decode's N deltas and N bases),
     each beside its bound and index_put_ of its writes. The
     output-stationary
     run writes of the same source, fill_sorted_runs and concat_row_spans,
     on every RUNS_CASES and CONCAT_CASES input placed by the built tile
     (against their plain versions and numpy references, one launch
     each), then at one real SE decode chunk's quality call and one real
     PE encode chunk's elision, recorded through repaq_tpu_torch.cli.main
     (chunk_calls, pe_chunk_calls), each timed beside its bound, beside
     one torch.take of precomputed indices and, in turns, beside the
     parent's composition (torch.full, the value gather and fill_runs; the
     elision's index_put_ into a dump slot). The stable bucket
     compaction (bucket_compact) on every COMPACT_CASES case, placed by
     the built tile of its form's route (n = 1, tile - 1, tile, tile + 1,
     past 3,000 tiles and past one wave of blocks, none and all kept, all
     kept cut at cap, a dense head, 8, 9, 64 and 256 buckets, a cut at
     cap, cap past n and 0, runs across tiles; against its plain version
     and a numpy argsort), then at every call of one SE chunk of phase 4's
     corpus, as the device path makes them (compact_shapes: the grouping
     of 12,582,912 bin ids, the N flags, the decode's token starts with
     their windows and the emission's three count >= 2 compactions), each
     timed beside its bound, its device kernels a call counted in a CUDA
     graph capture (one for a mask, two for ids), and timed in turns
     beside the parent's torch.sort of the same keys with its gather;
     after phase 5 both scans are held and timed again at the
     shapes the two corpora handed them (the SE and PE quality streams and
     coordinate rows, and decode token counts), and after
     phase 6 rans_encode is held and timed on the largest order-1 section
     the SE compress coded (real .rfq bytes), then tools/profile_rans.py's
     sweep of its block size, window and batch is logged at these shapes
     (every build exact against the package's), with the floor its state
     chain sets: the longest lane's steps times the cycles of one step
     (tools/rans_chain_probe.cu) at the card's maximum SM clock, and the
     same floor of rans_decode's step at RANS_SHAPES;
  3. goldens: `python -m repaq_tpu_torch.cli -c --engine device` on the
     single-end fixtures and, with -i/-I and -o/-O, the paired-end ones,
     byte-compared with the reference encoder's goldens, and `-d` back to
     the inputs;
  4. real size, single-end: a seeded ~96-Mbase corpus (640k reads of 150
     bp, Illumina names with X/Y, NovaSeq 4-bin qualities, 0.1% N)
     compressed in 12-Mbase chunks through repaq_tpu_torch.cli.main,
     byte-compared with the host engine's output, decompressed and
     compared with the input; every chunk must have taken the device path
     and every kernel of the SE path must have launched on it,
     run_offsets 3 times a chunk on compress and never on decompress,
     seg_positions once a chunk on decompress and never on compress (the
     same in phases 7 and 8; pe_encode_pairs likewise once a PE compress
     chunk and pe_decode_rows once a PE decompress chunk and never
     elsewhere, overlap_pairs never, fill_runs 3 times a compress chunk and
     twice a decompress chunk, fill_sorted_runs once a decompress chunk,
     concat_row_spans once a PE compress chunk,
     bucket_compact 5 times a compress chunk and once a decompress
     chunk), and the shapes they were handed are logged.
     The round
     trip runs twice: the first (cold) pays torch's lazy setup of each
     operator, the second (warm) is the steady rate. The token FSM is then
     timed at the median quality-buffer size of the corpus's chunks;
  5. real size, paired-end: the same for a seeded 2 x 320k-read corpus of
     150 bp pairs (96 Mbase, 8 chunks of 40k pairs) whose inserts give
     forward and backward mate overlaps, through -i/-I and -o/-O; the
     kernels of the PE path must have launched on it (pe_encode_pairs and
     pe_decode_rows once a chunk), no chunk may take the host route, and
     the shares of
     pairs stored with a forward and a backward overlap are printed and
     must each be at least 1%;
  6. `.rfqz`, both corpora: `-c -o x.rfqz --engine device` codes every
     rANS section on the card, at the CLI's default 16,000-kb chunks (the
     main path: the engine's 12-Mbase window sends the chunks to its host
     route) and with `-k 12000` (the engine's workers run chunks on the
     card while the main thread codes sections there; some chunk must take
     the device engine). In both the bytes must equal the host coder's
     (`--engine vectorized`, same chunking) and rans_encode must have
     launched once per section that reached the section coder (none took
     the host oracle). Then every rANS section of the default-chunk file
     (the LZ sections' inner ones included) is decoded on the card and
     held against rans_np, each section's order, live contexts and route
     counted and printed, and `-d` must give the inputs back; over phases
     2 and 6 rans_decode must have taken both routes. The section census,
     the ratio and both encode rates are printed;
  7. the multi-GPU mesh (--mesh_devices), both corpora: compress_se_mesh /
     compress_pe_mesh and decompress_se_mesh (PE with out2) on two engines
     sharing cuda:0 (the mesh path whose launch counts are reported) and,
     when torch sees more cards, on every card; then the CLI with
     --mesh_devices -1 both ways. Bytes must equal the serial run's of
     phase 4 or 5, the decode must give the inputs back, and every engine
     must have coded and decoded chunks on the device, none on the host
     route. The device count is
     printed: one card gives a byte check, not a scaling figure;
  8. sharded (--num_shards and the torch.distributed transport), both
     corpora at -k 12000: (a) the CLI, `--num_shards 2` compress with
     --engine device, each rank a process calling
     repaq_tpu_torch.cli.main(argv, engine=...) that prints its engine's
     stats and kernel launches, then `--num_shards 2` decompress of that
     .rfq; the bytes must equal the serial run's of phase 4 or 5, the
     decode must give the inputs back, every rank's chunks must have taken
     the device both ways, and encode_frontend, unpack_bases and
     token_start_mask must have launched in every rank (their sums are
     the launches of the shard_se and shard_pe paths). On one card both
     ranks share cuda:0; with more, rank r sees card r alone
     (CUDA_VISIBLE_DEVICES) and a run with one rank a card (at most 4) is
     added. (b) the transport, compress_distributed_torch: NCCL at world
     size 1 on cuda:0, gloo at world size 2 with both ranks' engines on
     cuda:0 and, with two or more cards, NCCL at world size min(count, 4),
     one card a rank; each must give the serial bytes, and each rank's
     timings and slab rounds are printed. Every rank process has a time
     limit, and any failure, timeout or non-zero rank fails the phase.

The last line of standard output is the JSON result; the two lines before
it are the kernels' JSON record and the nvidia-smi name/power line. Without
CUDA, or outside a checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import gzip
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke")

# (name, source, TPU kernel it replaces, the main paths that launch it)
KERNELS = [
    ("encode_frontend", "repaq_tpu_torch/csrc/frontend.cu",
     "repaq_tpu/ops/pallas_tpu.py:249",
     ("se", "pe", "mesh_se", "mesh_pe", "shard_se", "shard_pe")),
    ("encode_frontend_bytes", "repaq_tpu_torch/csrc/frontend.cu",
     "repaq_tpu/ops/pallas_tpu.py:249", ()),
    ("pack_bases", "repaq_tpu_torch/csrc/frontend.cu",
     "repaq_tpu/ops/pallas_tpu.py:94", ()),
    ("unpack_bases", "repaq_tpu_torch/csrc/unpack.cu",
     "repaq_tpu/ops/pallas_tpu.py:127",
     ("se", "pe", "mesh_se", "mesh_pe", "shard_se", "shard_pe")),
    ("token_start_mask", "repaq_tpu_torch/csrc/token_fsm.cu",
     "repaq_tpu/ops/pallas_tpu.py:175",
     ("se", "pe", "mesh_se", "mesh_pe", "shard_se", "shard_pe")),
    # the run-boundary and rANS kernels replace XLA code, not Pallas kernels
    ("run_offsets", "repaq_tpu_torch/csrc/scan.cu",
     "repaq_tpu/ops/device_streams.py:33, :37, :275-278, :726-730",
     ("se", "pe", "mesh_se", "mesh_pe", "shard_se", "shard_pe")),
    ("seg_positions", "repaq_tpu_torch/csrc/scan.cu",
     "repaq_tpu/ops/device_streams.py:1001, :1138",
     ("se", "pe", "mesh_se", "mesh_pe", "shard_se", "shard_pe")),
    ("rans_encode", "repaq_tpu_torch/csrc/rans.cu",
     "repaq_tpu/ops/rans_device.py:152", ("rfqz_se", "rfqz_pe")),
    ("rans_layout", "repaq_tpu_torch/csrc/rans.cu",
     "repaq_tpu/ops/rans_device.py:196", ("rfqz_se", "rfqz_pe")),
    ("rans_decode", "repaq_tpu_torch/csrc/rans.cu",
     "repaq_tpu/ops/rans_device.py:330", ()),
    ("overlap_pairs", "repaq_tpu_torch/csrc/overlap.cu",
     "repaq_tpu/ops/device_streams.py:1369", ()),
    # the PE steps' pair work: XLA code of the JAX steps
    ("pe_encode_pairs", "repaq_tpu_torch/csrc/overlap.cu",
     "repaq_tpu/codec/device_engine.py:580-591 (revcomp :582-583, search "
     ":587 via repaq_tpu/ops/device_streams.py:1369, clamp :589-591)",
     ("pe", "mesh_pe", "shard_pe")),
    ("pe_decode_rows", "repaq_tpu_torch/csrc/overlap.cu",
     "repaq_tpu/codec/device_engine.py:984-1001 (expansion), :1008-1009 "
     "(N restore), :1010-1021 (revcomp)",
     ("pe", "mesh_pe", "shard_pe")),
    # the decode's masked writes: XLA scatters aimed at a dump element
    ("fill_runs", "repaq_tpu_torch/csrc/fill.cu",
     "repaq_tpu/ops/device_streams.py:982, :992, :1211, :1228, :1257; "
     "repaq_tpu/codec/device_engine.py:845, :982; "
     "the emission's layout sorts, repaq_tpu/ops/device_streams.py:67, :76",
     ("se", "pe", "mesh_se", "mesh_pe", "shard_se", "shard_pe")),
    # the output-stationary route of the same source: the decode's quality
    # writes (full fill, token scatter and run grid, or the slot space)
    # and the PE elision's sort by destination
    ("fill_sorted_runs", "repaq_tpu_torch/csrc/fill.cu",
     "repaq_tpu/ops/device_streams.py:1160-1161, :1197, :1241-1242",
     ("se", "pe", "mesh_se", "mesh_pe", "shard_se", "shard_pe")),
    ("concat_row_spans", "repaq_tpu_torch/csrc/fill.cu",
     "repaq_tpu/codec/device_engine.py:606-618",
     ("pe", "mesh_pe", "shard_pe")),
    # the compaction and grouping sorts
    ("bucket_compact", "repaq_tpu_torch/csrc/compact.cu",
     "repaq_tpu/ops/device_streams.py:136, :187, :237, :403-419, :502, "
     ":536, :1094",
     ("se", "pe", "mesh_se", "mesh_pe", "shard_se", "shard_pe")),
]

# why a kernel is on no main path (its launches there are 0)
NO_PATH = {
    "encode_frontend_bytes": "none: the PE encode reads encode_frontend's "
                             "meta bytes; the byte form keeps JAX's "
                             "signature for the tests and phase 2",
    "pack_bases": "none: no production caller, in the JAX package either",
    "rans_decode": "none: the CLI reads .rfqz with the host decoder, as the "
                   "JAX CLI does; held against its plain version in phase 2 "
                   "and against rans_np on every section in phase 6",
    "overlap_pairs": "none: pe_encode_pairs runs the same search inside its "
                     "tiles on the PE encode path; the search alone keeps "
                     "JAX's overlap_pairs_device signature for the tests "
                     "and phase 2 (OVERLAP_CASES and a PE chunk's grid)",
}

# rANS sections (order, bytes, lanes): an order-1 section the size of the
# largest ones phase 6 codes (2048 lanes, one per 16,000-kb chunk), and a
# 16 MB order-0 one (RfqzWriter's block size)
RANS_SHAPES = [(1, 2_285_523, 2048), (0, 16_000_000, 4096)]

# the 12-Mbase encode block of bench.py's device section (bench.py:1262)
B_READS, READ_LEN = 77824, 152
# the PE path's padded chunk at 40k pairs of 150 bp: b_cap 98304 rows
PE_BASES = 98304 * 150
PE_PAIRS, PE_PAIR_CAP = 40_000, 98304 // 2

PE_GOLDENS = [
    ("pe_R1", "pe_R2", "pe.ref.rfq", []),
    ("pe_big_R1", "pe_big_R2", "pe_big.ref.k100.rfq", ["-k", "100"]),
    ("pe_nov_R1", "pe_nov_R2", "pe_nov.ref.rfq", []),
    ("pe_nl1", "pe_nl2", "pe_nl.ref.rfq", ["-k", "100"]),
]

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

# the card's memory rate (H100 SXM data sheet): every kernel here moves a
# few bytes per operation, so its bound is its bytes over this rate
HBM_BYTES_PER_S = 3.35e12

# NovaSeq 4-bin quality profile: F (Q37), : (Q25), , (Q11), # (Q2)
NOVA_QUALS = b"F:,#"
NOVA_P = [0.86, 0.09, 0.04, 0.01]


def log(msg: str) -> None:
    print(msg, flush=True)


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(r.returncode == 0, "nvidia-smi failed: %s" % r.stderr.strip())
    return r.stdout.strip().splitlines()[0]


def build_native() -> None:
    """Build the port's native host library from repaq_tpu_torch/native/
    and load it; a failed build raises with the compiler's message."""
    import numpy as np

    from repaq_tpu_torch.codec import _native, kernels_np as K, oracle

    t0 = time.perf_counter()
    path = _native.build()
    check(_native.available(), "native host library built at %s but did "
          "not load (REPAQ_TPU_NO_NATIVE set?)" % path)
    seq = np.frombuffer(b"ACGTNACGTN" * 4000, np.uint8)
    check(K.pack_2bit(seq).tobytes()
          == oracle.pack_bases_2bit(seq.tobytes()),
          "native pack_2bit differs from the oracle")
    log("native host library: built from repaq_tpu_torch/native/ and loaded "
        "in %.1f s (%s)" % (time.perf_counter() - t0,
                            os.path.relpath(path, ROOT)))


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def cuda_ms(fn, runs: int = 15, clean: bool = False, setup=None) -> float:
    """Median device time of fn() in ms: CUDA events around each call, the
    L2 flushed and the stream kept busy before each so that neither a warm
    cache nor the host's enqueue time is measured. The flush writes 64 MB,
    whose dirty lines fn()'s reads then write back; clean=True flushes by
    reading them instead. setup(), untimed, runs before each flush (a
    kernel that works in place gets its inputs back)."""
    import torch

    flush = torch.zeros(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    fn()
    times = []
    for _ in range(runs):
        if setup is not None:
            setup()
        if clean:
            flush.sum()
        else:
            flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(got, want) -> int:
    if isinstance(got, tuple):
        return max(max_abs_err(g, w) for g, w in zip(got, want))
    return int((got.long() - want.long()).abs().max().item())


def nbytes(*tensors) -> int:
    """Bytes of the tensors (nested tuples flattened, None skipped)."""
    total = 0
    for t in tensors:
        if isinstance(t, tuple):
            total += nbytes(*t)
        elif t is not None:
            total += t.numel() * t.element_size()
    return total


def bound_fields(moved: int, ms: float) -> dict:
    """The least time the card could take for `moved` bytes at its memory
    rate, which bounds every kernel here (a few integer operations per
    byte), and the kernel's share of it."""
    bound = 1e3 * moved / HBM_BYTES_PER_S
    return {"bound_ms": bound, "bound_by": "bytes",
            "share_of_bound": bound / ms}


def fill_moved(out, start, count, value, keep=None) -> int:
    """The bytes fill_runs must move: keep for every entry (without keep,
    count, where it is a tensor: either says which entries write), count
    for the kept entries, start and value (where they are tensors) for the
    entries that write, and each element written once."""
    import torch

    n = start.shape[0]
    cnt = (count.long() if isinstance(count, torch.Tensor)
           else torch.full((n,), int(count), dtype=torch.long,
                           device=start.device))
    kept = (torch.ones(n, dtype=torch.bool, device=start.device)
            if keep is None else keep)
    writes = kept & (cnt >= 1)
    moved = nbytes(keep) + (int(kept.sum()) * 4 if keep is not None
                            and isinstance(count, torch.Tensor) else 0)
    if keep is None:
        moved += nbytes(count) if isinstance(count, torch.Tensor) else 0
    w = int(writes.sum())
    moved += w * 4
    if isinstance(value, torch.Tensor):
        moved += w * value.element_size()
    lo = start.long().clamp(min=0)
    hi = (start.long() + cnt).clamp(max=out.shape[0])
    elements = int(torch.where(writes, (hi - lo).clamp(min=0), 0).sum())
    return moved + elements * out.element_size()


def held_and_timed(name, kern, plain, inputs, shape, plain_runs=15,
                   moved=None, library=None) -> dict:
    """kern() exact against plain(), both timed; moved: the bytes the
    function must move (default: its inputs read once, its outputs written
    once); library: one PyTorch call that computes the same function, timed
    beside them as a yardstick."""
    import torch

    got = kern()
    want = plain()
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    check(err == 0, "%s differs from its plain version at %s (max abs err "
          "%d)" % (name, shape, err))
    ms = cuda_ms(kern)
    plain_ms = cuda_ms(plain, runs=plain_runs)
    if moved is None:
        moved = nbytes(*inputs) + nbytes(got)
    res = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           **bound_fields(moved, ms),
           "library_ms": None if library is None else cuda_ms(library)}
    log("kernel %-21s exact at %s: %.4f ms (bound %.4f ms, %.0f%%), plain "
        "torch %.4f ms%s" % (name, shape, ms, res["bound_ms"],
                             100 * res["share_of_bound"], plain_ms,
                             "" if library is None else ", library %.4f ms"
                             % res["library_ms"]))
    return res


FSM_KINDS = ("random", "forced_edges", "all4", "all4_shifted", "clamp")


def fsm_case(n: int, kind: str, seed: int, tile: int):
    """(lens int32, force or None) of one token-FSM edge case, of a kind in
    FSM_KINDS: random 1/2/4-byte tokens without force ("random"), or with
    0.1% forced restarts plus one at every tile's first byte
    ("forced_edges"); all 4-byte tokens ("all4"), the same after one 1-byte
    token so that tokens cross the tile edges ("all4_shifted"); lengths
    the kernel clamps to 1..4 (-1, 0, 5, 6, 255, 300 among 1/2/4; -1 and
    300 are 255 and 44 as uint8) with the forced restarts ("clamp")."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if kind.startswith("all4"):
        lens = np.full(n, 4, dtype=np.int32)
        lens[0] = 1 if kind == "all4_shifted" else 4
        return lens, None
    pool = [1, 1, 2, 4] + ([-1, 0, 5, 6, 255, 300] if kind == "clamp" else [])
    lens = rng.choice(pool, size=n).astype(np.int32)
    if kind == "random":
        return lens, None
    force = rng.random(n) < 0.001
    force[::tile] = True
    return lens, force


def fsm_edge_cases(dev) -> int:
    """The token FSM exact against its plain version, one launch a call,
    at n = 1, tile - 1, tile, tile + 1 and past 3,000 tiles, for every
    fsm_case kind, with uint8 and int32 lengths; returns the case count."""
    import torch

    from repaq_tpu_torch.ops import kernels as TK

    tile = TK.fsm_tile()
    cases = 0
    for n in (1, tile - 1, tile, tile + 1, 3000 * tile + 5):
        for kind in FSM_KINDS:
            lens, force = fsm_case(n, kind, n, tile)
            lens = torch.from_numpy(lens).to(dev)
            force = None if force is None else torch.from_numpy(force).to(dev)
            for dtype in (torch.uint8, torch.int32):
                lens_t = lens.to(dtype)
                want = TK.token_start_mask_plain(lens_t, force)
                before = TK.launches["token_start_mask"]
                got = TK.token_start_mask(lens_t, force)
                torch.cuda.synchronize()
                check(TK.launches["token_start_mask"] == before + 1,
                      "token_start_mask took more than one launch")
                check(torch.equal(got, want), "token_start_mask differs from "
                      "its plain version at n=%d, %s, %s lengths"
                      % (n, kind, dtype))
                cases += 1
    return cases


RUN_KINDS = ("random", "sparse", "dense", "all", "none", "edges", "long")
SEG_KINDS = ("random", "first", "every", "none", "edges")


def run_case(n: int, rows: int, kind: str, seed: int, tile: int = 8192):
    """A bool mask for run_offsets, (n,) when rows == 0, else (rows, n), of
    a kind in RUN_KINDS: set with probability 1/2 ("random"), 1/5
    ("sparse") or 97/100 ("dense": runs past 32); all set (one run through
    every tile) or none; runs of 31, 32 and 33 elements ending at, one past
    and across every multiple of tile / 16 ("edges": the kernel's steps,
    warps and tiles, given its tile); or one run three tiles long from half
    a tile on, among sparse ones ("long")."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shape = (n,) if rows == 0 else (rows, n)
    if kind in ("random", "sparse", "dense", "long"):
        p = {"random": 0.5, "sparse": 0.2, "dense": 0.97, "long": 0.2}[kind]
        mask = rng.random(shape) < p
        if kind == "long":
            mask[..., tile // 2: tile // 2 + 3 * tile] = True
        return mask
    mask = np.full(shape, kind == "all")
    if kind == "edges":
        step = max(1, tile // 16)
        for t, b in enumerate(range(step, n + step, step)):
            length = 31 + (t // 3) % 3
            end = b + (0, 1, length // 2)[t % 3]
            mask[..., max(0, end - length): end] = True
    return mask


def seg_case(n: int, kind: str, seed: int, tile: int = 8192):
    """(adv int32, seg_start bool), both (n,), for seg_positions, of a kind
    in SEG_KINDS: segment starts with probability 1/100 ("random"), at the
    first element only, at every element, at none, or at, before and after
    every multiple of tile / 8 ("edges": the kernel's warps and tiles,
    given its tile). adv is 0-64 with a stretch of 100 zeros in every 1000
    elements (every prefix sum below 2^30 up to 16M elements); "random"
    draws it up to 2^24 where n allows (prefix sums below 2^30)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    top = min(1 << 24, (1 << 30) // max(n, 1)) if kind == "random" else 64
    adv = rng.integers(0, top + 1, size=n, dtype=np.int64).astype(np.int32)
    adv[(np.arange(n) // 100) % 10 == 3] = 0
    if kind == "random":
        start = rng.random(n) < 0.01
    else:
        start = np.full(n, kind == "every")
    if kind == "first" and n:
        start[0] = True
    if kind == "edges":
        step = max(1, tile // 8)
        for b in range(0, n + 1, step):
            start[max(0, b - 1): b + 2] = True
    return adv, start


def boundary_edge_cases(dev) -> int:
    """run_offsets and seg_positions exact against their plain versions,
    one launch a call (none for an empty input), at n = 1, tile - 1, tile,
    tile + 1, 3 tiles + 5 and past 3,000 tiles (run_offsets 1-D and as 2
    rows, whose second row starts unaligned at these n), for every
    run_case and seg_case kind, and on inputs whose start is not 16-byte
    aligned; returns the case count."""
    import torch

    from repaq_tpu_torch.ops import kernels as TK

    run_tile, seg_tile = TK.run_tiles()
    cases = []
    for n in (1, run_tile - 1, run_tile, run_tile + 1, 3 * run_tile + 5,
              3000 * run_tile + 5):
        for rows in (0, 2):
            for kind in RUN_KINDS:
                cases.append(("run_offsets", (torch.from_numpy(
                    run_case(n, rows, kind, n + rows, run_tile)).to(dev),)))
    for n in (1, seg_tile - 1, seg_tile, seg_tile + 1, 3 * seg_tile + 5,
              3000 * seg_tile + 5):
        for kind in SEG_KINDS:
            cases.append(("seg_positions", tuple(
                torch.from_numpy(a).to(dev)
                for a in seg_case(n, kind, n, seg_tile))))
    mask = torch.from_numpy(run_case(run_tile + 9, 0, "dense", 9)).to(dev)
    adv, start = (torch.from_numpy(a).to(dev)
                  for a in seg_case(seg_tile + 9, "random", 9))
    cases += [("run_offsets", (mask[1:],)),
              ("run_offsets", (torch.zeros((2, 0), dtype=torch.bool,
                                           device=dev),)),
              ("seg_positions", (adv[1:], start[1:]))]
    for name, args in cases:
        kern = getattr(TK, name)
        plain = getattr(TK, name + "_plain")
        before = TK.launches[name]
        got = kern(*args)
        torch.cuda.synchronize()
        check(TK.launches[name] == before + (args[0].numel() > 0),
              "%s took other than one launch" % name)
        want = plain(*args)
        if name == "seg_positions":
            got, want = (got,), (want,)
        check(all(torch.equal(g, w) for g, w in zip(got, want)), "%s differs "
              "from its plain version at shape %s"
              % (name, tuple(args[0].shape)))
    return len(cases)


def boundary_kernels_at(dev, name: str, shape: tuple, label: str,
                        seed: int) -> dict:
    """run_offsets on a "random" mask, or seg_positions on "random" inputs,
    of `shape`, exact against its plain version, timed beside its bound
    (no single PyTorch call computes either)."""
    import torch

    from repaq_tpu_torch.ops import kernels as TK

    if name == "run_offsets":
        rows = shape[0] if len(shape) == 2 else 0
        args = (torch.from_numpy(run_case(shape[-1], rows, "random",
                                          seed)).to(dev),)
    else:
        args = tuple(torch.from_numpy(a).to(dev)
                     for a in seg_case(shape[0], "random", seed))
    return held_and_timed(name, lambda: getattr(TK, name)(*args),
                          lambda: getattr(TK, name + "_plain")(*args), args,
                          label)


# one SE decode chunk's quality writes: phase 4's corpus in 12-Mbase chunks
# (80,000 reads of 150 bp, NovaSeq qualities) as DeviceEngine._decode_caps
# sizes its first chunk: tokens, positions, the token cap and the run cap
FILL_CHUNK = {"length": 12_582_912, "tok_cap": 2_359_296,
              "tokens": 1_680_349, "positions": 1_689_953,
              "run_cap": 786_432, "major": ord("F")}


def fill_chunk_inputs(dev, seed: int = 1047):
    """(out, start, count, value, keep) of FILL_CHUNK's quality writes: out
    the major-filled (length,) buffer; the tokens ordered by bin, then by
    position (NovaSeq's three non-major bins), each at a distinct even
    position, positions - tokens of them runs of 2; the rest of the token
    cap masked, with count 0."""
    import numpy as np
    import torch

    c = FILL_CHUNK
    rng = np.random.default_rng(seed)
    t, cap = c["tokens"], c["tok_cap"]
    pos = np.sort(rng.choice(c["length"] // 2, size=t, replace=False)) * 2
    p = np.array(NOVA_P[1:]) / sum(NOVA_P[1:])
    bin_of = rng.choice(3, size=t, p=p)
    order = np.lexsort((pos, bin_of))
    count = np.ones(t, dtype=np.int32)
    count[rng.choice(t, size=c["positions"] - t, replace=False)] = 2
    value = np.frombuffer(NOVA_QUALS[1:], np.uint8)[bin_of[order]]

    def padded(a, dtype):
        out = np.zeros(cap, dtype=dtype)
        out[:t] = a
        return torch.from_numpy(out).to(dev)

    start = padded(pos[order], np.int32)
    count = padded(count, np.int32)
    out = torch.full((c["length"],), c["major"], dtype=torch.uint8,
                     device=dev)
    return (out, start, count, padded(value, np.uint8), count >= 1)


# fill_runs' edge cases, each in every output type: no entries, counts of
# 0, 1 and 32, starts below 0, runs clipped at the end, none kept, every
# entry kept (keep None), one count and one value for all, an output view
# one element off its allocation's start, counts of 0-32 at random
# alignments, and an SE-chunk-like mix (2^16 entries, ~70% kept, ~0.6%
# runs of 2-32, ordered by bin as the decode's tokens are); all but the
# empty case cross a 1,024-entry block edge
FILL_CASES = ("empty", "count0", "count1", "count32", "neg_start",
              "clip_end", "keep_none", "keep_all", "scalars", "unaligned",
              "mixed", "se_mix")
FILL_DTYPES = ("uint8", "bool", "int32")


def fill_case(name: str, dtype: str):
    """(out, start, count, value, keep, off) numpy arrays of a FILL_CASES
    case: out the buffer whose view out[off:] is written, start int32,
    count int32 or one int, value of out's type or one scalar, keep bool or
    None. Kept runs never overlap, so the result is defined."""
    import numpy as np

    rng = np.random.default_rng(1000 + 10 * FILL_CASES.index(name)
                                + FILL_DTYPES.index(dtype))
    n = {"empty": 0, "se_mix": 1 << 16}.get(name, 3 * 1024 + 5)
    if name == "count0":
        count = np.zeros(n, np.int32)
    elif name in ("count1", "scalars"):
        count = np.ones(n, np.int32)
    elif name == "count32":
        count = np.full(n, 32, np.int32)
    elif name in ("mixed", "unaligned"):
        count = rng.integers(0, 33, size=n).astype(np.int32)
    elif name == "se_mix":
        count = np.ones(n, np.int32)
        runs = rng.random(n) < 0.006
        count[runs] = rng.integers(2, 33, size=int(runs.sum()))
    else:
        count = rng.integers(1, 33, size=n).astype(np.int32)
    gaps = rng.integers(0, 8, size=n)
    start = (np.cumsum(count + gaps) - count).astype(np.int32)
    size = int(start[-1] + count[-1]) + 5 if n else 16
    if name == "neg_start":
        start -= int(start[min(n - 1, 40)]) + 3
    if name == "clip_end":
        size = int(start[n // 2]) + int(count[n // 2]) // 2 + 1
    off = int(name == "unaligned")
    keep = rng.random(n) < (0.7 if name == "se_mix" else 0.9)
    if name == "keep_none":
        keep[:] = False
    if name == "keep_all":
        keep = None
    if dtype == "bool":
        value = rng.random(n) < 0.5
        out = rng.random(size + off) < 0.5
    else:
        info = np.iinfo(dtype)
        value = rng.integers(info.min, info.max, size=n, endpoint=True,
                             dtype=dtype)
        out = rng.integers(info.min, info.max, size=size + off,
                           endpoint=True, dtype=dtype)
    if name == "se_mix":
        order = np.lexsort((start, rng.integers(0, 3, size=n)))
        start, count, value, keep = (a[order] for a in (start, count, value,
                                                          keep))
    if name == "scalars":
        count, value = 1, {"uint8": 78, "bool": True, "int32": -5}[dtype]
    return out, start, count, value, keep, off


def fill_loop(out, start, count, value, keep):
    """fill_case's writes done by a numpy loop: a copy of out, each kept
    run written, its targets clipped to the output."""
    import numpy as np

    out = out.copy()
    n = out.shape[0]
    for i in range(start.shape[0]):
        if keep is not None and not keep[i]:
            continue
        c = count if np.isscalar(count) else int(count[i])
        lo, hi = max(int(start[i]), 0), min(int(start[i]) + c, n)
        if lo < hi:
            out[lo:hi] = value if np.isscalar(value) else value[i]
    return out


def fill_args(case, dev):
    """fill_case's arrays as fill_runs' arguments on dev: (buf, out, start,
    count, value, keep), out the view of buf that is written."""
    import numpy as np
    import torch

    buf, start, count, value, keep, off = case

    def on(a):
        return a if a is None or np.isscalar(a) or isinstance(a, int) \
            else torch.from_numpy(a.copy()).to(dev)

    buf = on(buf)
    return (buf, buf[off:], on(start), on(count), on(value), on(keep))


def parent_qual_fill(out, start, count, value, keep, run_cap: int):
    """The writes fill_runs replaced on the decode, as the parent's
    qualcol_decode_device made them in token space: a copy of out with a
    spare last byte that takes every masked write, one index_put_ a token,
    then the (run_cap, 4, 31) grid of the 4-token groups holding a run,
    compacted by a sort, in one more index_put_."""
    import torch

    length, dev = out.shape[0], out.device
    i32 = torch.int32
    qual = torch.cat([out, out.new_zeros(1)])
    ok_t = keep & (start >= 0) & (start < length)
    qual[torch.where(ok_t, start, length).long()] = value
    rmask = keep & (count >= 2)
    pad4 = (-start.shape[0]) % 4
    zi = torch.zeros(pad4, dtype=i32, device=dev)
    rmask = torch.cat([rmask, torch.zeros(pad4, dtype=torch.bool,
                                          device=dev)])
    rp = torch.cat([start, zi]).view(-1, 4)
    rn = torch.cat([count, zi]).view(-1, 4)
    rv = torch.cat([value, zi.to(torch.uint8)]).view(-1, 4)
    ng = rp.shape[0]
    run_cap_eff = max(1, min(run_cap, ng + 1))
    g_has = rmask.view(-1, 4).any(dim=1)
    gidx = torch.sort(torch.where(g_has, torch.arange(ng, dtype=i32,
                                                      device=dev), ng)
                      ).values[:run_cap_eff].long()

    def _g4(x):
        return torch.cat([x, x.new_zeros((1, 4))])[gidx]

    rp, rn, rv = _g4(rp), _g4(rn), _g4(rv)
    rm = _g4(rmask.view(-1, 4))
    lanes31 = torch.arange(1, 32, dtype=i32, device=dev)[None, None, :]
    cand = rp[:, :, None] + lanes31
    cv = (rm[:, :, None] & (lanes31 < rn[:, :, None]) & (cand >= 0)
          & (cand < length))
    qual[torch.where(cv, cand, length).reshape(-1).long()] = (
        rv[:, :, None].expand(cv.shape).reshape(-1))
    return qual[:length]

def fill_edge_cases(dev) -> int:
    """fill_runs exact against its plain version and fill_loop on every
    FILL_CASES case in every output type, one launch each (none for no
    entries), the element before an offset view left alone; returns the
    number of cases."""
    import torch

    from repaq_tpu_torch.ops import kernels as TK

    done = 0
    for name in FILL_CASES:
        for dtype in FILL_DTYPES:
            case = fill_case(name, dtype)
            buf, out, start, count, value, keep = fill_args(case, dev)
            before = TK.launches["fill_runs"]
            got = TK.fill_runs(out, start, count, value, keep)
            torch.cuda.synchronize()
            check(TK.launches["fill_runs"] == before + (start.shape[0] > 0),
                  "fill_runs launched %d times on %s %s"
                  % (TK.launches["fill_runs"] - before, name, dtype))
            _b, pout, *pargs = fill_args(case, dev)
            off = case[5]
            check(torch.equal(got, TK.fill_runs_plain(pout, *pargs))
                  and (got.cpu().numpy() == fill_loop(
                      case[0][off:], *case[1:5])).all()
                  and (buf[:off].cpu().numpy() == case[0][:off]).all(),
                  "fill_runs differs from its plain version on %s %s"
                  % (name, dtype))
            done += 1
    return done


def fill_kernel_phase(dev) -> dict:
    """fill_runs on its edge cases, then at one SE decode chunk's quality
    writes (FILL_CHUNK, keep None as the decode calls it) exact against
    its plain version, timed beside its bound (fill_moved: the count of
    every entry, start and value of those that write, the run elements
    written once), beside
    index_put_ of the same writes given as distinct indices (the library
    call, fill_library) and, in turns, beside the parent's composition of
    the same writes (parent_qual_fill: the token index_put_, the 73
    M-entry run grid and its index_put_); also at the N stream's modeled
    shapes of that chunk: the int32 deltas (786,432 entries, the starts
    kept) and the N bases (786,432 entries, -1 past the real ones, one
    value); then at every call of one real SE chunk recorded through
    cli.main (chunk_calls, FILL_CALLS: the encode's three layout writes,
    the decode's N deltas and N bases), each beside its bound and its
    index_put_."""
    import numpy as np
    import torch

    from repaq_tpu_torch.ops import kernels as TK

    log("kernel fill_runs exact on %d edge cases (FILL_CASES in uint8, bool "
        "and int32: no entries, counts 0, 1 and 32, starts below 0, runs "
        "clipped at the end, none kept, all kept, one count and value, an "
        "offset view, counts 0-32 at random alignments, an SE-like mix of "
        "2^16 entries), one launch each" % fill_edge_cases(dev))
    c = FILL_CHUNK
    out, start, count, value, keep = fill_chunk_inputs(dev)
    plain_out = out.clone()
    written = int(count.sum())
    shape = ("%d entries (%d with count >= 1, %d runs), %d elements "
             "written into %d" % (start.shape[0], int(keep.sum()),
                                  written - c["tokens"], written,
                                  c["length"]))
    entry = torch.repeat_interleave(torch.arange(start.shape[0],
                                                 device=dev), count.long())
    idx = (start.long()[entry] + torch.arange(written, device=dev)
           - (torch.cumsum(count.long(), 0) - count.long())[entry])
    vals = value[entry]
    # keep None, as qualcol_decode_device calls it: count 0 masks the tail
    res = held_and_timed(
        "fill_runs", lambda: TK.fill_runs(out, start, count, value),
        lambda: TK.fill_runs_plain(plain_out, start, count, value),
        (start, count, value), shape,
        moved=fill_moved(out, start, count, value),
        library=lambda: out.index_put_((idx,), vals))
    del entry, idx, vals
    base = torch.full_like(out, c["major"])

    def kernel():
        return TK.fill_runs(base.clone(), start, count, value)

    def parent():
        return parent_qual_fill(base, start, count, value, keep,
                                c["run_cap"])

    check(torch.equal(kernel(), parent()), "fill_runs differs from the "
          "parent's composition at %s" % shape)
    turns = [("parent", parent), ("fill_runs", kernel),
             ("fill_runs", kernel), ("parent", parent)]
    times = {"parent": [], "fill_runs": []}
    for name, fn in turns:
        times[name].append(cuda_ms(fn))
    res["parent_ms"] = times["parent"]
    res["with_copy_ms"] = times["fill_runs"]
    log("kernel fill_runs at %s with a copy of the output, in turns with the "
        "parent's composition (the token index_put_, the run grid of %d "
        "entries and its index_put_): parent %s ms, fill_runs %s ms"
        % (shape, min(c["run_cap"], (start.shape[0] + 3) // 4) * 124,
           ", ".join("%.4f" % t for t in times["parent"]),
           ", ".join("%.4f" % t for t in times["fill_runs"])))
    # the N stream's writes in the same chunk: 12,573 N positions
    rng = np.random.default_rng(1231)
    m = c["length"] // 16
    real = min(12_573, m // 2)
    pos = np.full(m, -1, np.int32)
    pos[:real] = np.sort(rng.choice(c["length"], size=real, replace=False))
    first = torch.from_numpy(np.sort(rng.choice(m, size=real,
                                                replace=False))
                             .astype(np.int32)).to(dev)
    slot = torch.full((m,), m, dtype=torch.int32, device=dev)
    slot[:real] = first
    dist = torch.from_numpy(rng.integers(1, 2000, size=m,
                                         dtype=np.int32)).to(dev)
    starts = torch.zeros(m, dtype=torch.bool, device=dev)
    starts[:real] = True
    deltas, pdeltas = (torch.ones(m, dtype=torch.int32, device=dev)
                       for _ in range(2))
    seq = torch.full((c["length"],), ord("G"), dtype=torch.uint8,
                     device=dev)
    pseq = seq.clone()
    pos_t = torch.from_numpy(pos).to(dev)
    res["by_shape"] = {shape: dict(res)}
    for label, kern, plain, inputs, moved in (
            ("modeled N deltas: %d int32 entries, %d kept" % (m, real),
             lambda: TK.fill_runs(deltas, slot, 1, dist, starts),
             lambda: TK.fill_runs_plain(pdeltas, slot, 1, dist, starts),
             (slot, dist, starts), fill_moved(deltas, slot, 1, dist,
                                              starts)),
            ("modeled N bases: %d entries, %d in the output, one value"
             % (m, real),
             lambda: TK.fill_runs(seq, pos_t, 1, ord("N")),
             lambda: TK.fill_runs_plain(pseq, pos_t, 1, ord("N")),
             (pos_t,), fill_moved(seq, pos_t, 1, ord("N")))):
        res["by_shape"][label] = held_and_timed(
            "fill_runs", kern, plain, inputs, label, moved=moved,
            library=fill_library(*((deltas, slot, 1, dist, starts)
                                   if "deltas" in label
                                   else (seq, pos_t, 1, ord("N")))))
    # every call of one real SE chunk as the main path makes it
    # (chunk_calls): the encode's three layout writes and the decode's N
    # deltas and N bases, in place on copies of the recorded outputs
    calls = chunk_calls(dev)["fill_runs"]
    check(len(calls) == len(FILL_CALLS), "the SE chunk called fill_runs %d "
          "times, not %d" % (len(calls), len(FILL_CALLS)))
    for what, (out0, start, count, value, *keep) in zip(FILL_CALLS, calls):
        keep = keep[0] if keep else None
        o1, o2 = out0.clone(), out0.clone()
        label = ("SE chunk %s: %d entries into %d %s" % (
            what, start.shape[0], out0.shape[0], str(out0.dtype)[6:]))
        res["by_shape"][label] = held_and_timed(
            "fill_runs", lambda: TK.fill_runs(o1, start, count, value, keep),
            lambda: TK.fill_runs_plain(o2, start, count, value, keep), (),
            label, moved=fill_moved(o1, start, count, value, keep),
            library=fill_library(out0, start, count, value, keep))
    return res


# fill_runs' calls in one SE chunk of the smoke corpora, in the order the
# device path makes them
FILL_CALLS = ("quality stream layout", "N-position stream layout",
              "coordinate streams layout", "N deltas", "N bases")


def fill_library(out, start, count, value, keep=None):
    """One index_put_ that makes fill_runs' writes, as a function of no
    arguments: its written targets as distinct int64 indices and their
    values, built beforehand; the library call timed as a yardstick. It
    writes into a copy of out."""
    import torch

    n, dev = start.shape[0], start.device
    cnt = (count.long() if isinstance(count, torch.Tensor)
           else torch.full((n,), int(count), dtype=torch.long, device=dev))
    if keep is not None:
        cnt = torch.where(keep, cnt, 0)
    cnt = cnt.clamp(min=0)
    entry = torch.repeat_interleave(torch.arange(n, device=dev), cnt)
    first = torch.cumsum(cnt, 0) - cnt
    tgt = (start.long()[entry] + torch.arange(entry.shape[0], device=dev)
           - first[entry])
    ok = (tgt >= 0) & (tgt < out.shape[0])
    vals = (value[entry] if isinstance(value, torch.Tensor)
            else torch.full((entry.shape[0],), value, dtype=out.dtype,
                            device=dev))
    idx, vals = tgt[ok], vals[ok]
    target = out.clone()
    return lambda: target.index_put_((idx,), vals)


# ---------------------------------------------------------------------------
# sorted runs (fill_sorted_runs, concat_row_spans): csrc/fill.cu's
# output-stationary route
# ---------------------------------------------------------------------------

# fill_sorted_runs' edge cases, placed by the built tile T: no entries, no
# segments, empty segments among full ones, runs across, ending at and
# starting at every tile edge, runs clipped at the end (an end past 2^31)
# and below 0 (a start at -2^31), count-0 and negative-count entries
# between runs (in order) and inside one (out of order: read whole), one
# segment of every entry at the decode's density, a length that is no
# multiple of 16, a segment whose int32 positions wrap (read whole) in
# check blocks it shares with clean segments, a later segment over an
# earlier one's bytes, offsets out of order and out of range, entries past
# the last offset (never read), 63 and 256 segments, runs longer than a
# tile, and 1,100 tiles (more than one wave of blocks)
RUNS_CASES = ("empty", "no_segments", "empty_segments", "straddle",
              "clip_end", "neg_start", "count0", "count0_inside",
              "one_segment", "len_not16", "wrap", "later_wins",
              "offsets_unsorted", "tail", "segments63", "segments256",
              "long_runs", "tiles1100")


def _ordered_runs(rng, n: int, first: int = 0, gap: int = 8,
                  p_run: float = 0.006, max_count: int = 32):
    """(start, count) int64 of n runs in order, each ending before the
    next one starts: counts 1 (2..max_count at rate p_run), gaps 0..gap-1,
    the first at `first`."""
    import numpy as np

    count = np.ones(n, np.int64)
    runs = rng.random(n) < p_run
    count[runs] = rng.integers(2, max_count + 1, size=int(runs.sum()))
    st = first + np.cumsum(count + rng.integers(0, gap, size=n)) - count
    return st, count


def _segments(parts: list):
    """start, count (int32) and seg_off of (start, count) parts, one
    segment a part."""
    import numpy as np

    sizes = [len(p[0]) for p in parts]
    cat = [np.concatenate([p[i] for p in parts]) if parts
           else np.zeros(0, np.int64) for i in (0, 1)]
    return (cat[0].astype(np.int32), cat[1].astype(np.int32),
            np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32))


def runs_case(name: str, tile: int):
    """(length, background, start, count, seg_off, seg_value) of a
    RUNS_CASES case at a tile of `tile` output bytes: numpy int32 start,
    count and seg_off, uint8 seg_value."""
    import numpy as np

    rng = np.random.default_rng(1900 + RUNS_CASES.index(name))
    T = tile
    length = 4 * T + 5
    parts = []
    if name == "empty":
        parts = [(np.zeros(0, np.int64),) * 2] * 2
    elif name == "no_segments":
        parts = []
    elif name == "empty_segments":
        full = [_ordered_runs(rng, T // 3, gap=12) for _ in range(2)]
        e = (np.zeros(0, np.int64),) * 2
        parts = [e, full[0], e, e, full[1], e]
    elif name == "straddle":
        length = 6 * T + 7
        edges = np.arange(1, 7) * T
        a = (np.stack([edges - 20, edges - 3, edges + 6], 1).ravel(),
             np.tile([4, 8, 32], 6))
        b = (np.stack([edges - 10, edges], 1).ravel(), np.full(12, 10))
        parts = [a, b]
    elif name == "clip_end":
        length = 3 * T + 9
        st, c = _ordered_runs(rng, T // 4, first=length - T // 2, gap=10)
        st, c = st[st + c <= length - 5], c[st + c <= length - 5]
        parts = [(np.concatenate([st, [length - 5, length, length + 7,
                                       2**31 - 10]]),
                  np.concatenate([c, [3, 5, 40, 100]]))]
    elif name == "neg_start":
        st, c = _ordered_runs(rng, T // 4, first=5)
        parts = [(np.concatenate([[-2**31, -40, -1], st]),
                  np.concatenate([[5, 32, 3], c]))]
    elif name in ("count0", "count0_inside"):
        st, c = _ordered_runs(rng, T, gap=10, p_run=0.2)
        zero = rng.random(T) < 0.2
        c[zero] = np.where(rng.random(int(zero.sum())) < 0.5, 0, -7)
        if name == "count0_inside":
            # a count-0 entry starting inside the run before it
            i = int(np.flatnonzero(c[:-1] > 3)[5])
            st[i + 1], c[i + 1] = st[i] + 2, 0
        parts = [(st, c)]
    elif name == "one_segment":
        parts = [_ordered_runs(rng, (length * 2) // 15, gap=14)]
    elif name == "len_not16":
        length = 5 * T + 13
        st, c = _ordered_runs(rng, length // 5, gap=8)
        keep = st + c <= length - 16
        parts = [(np.concatenate([st[keep], [length - 13, length - 3]]),
                  np.concatenate([c[keep], [7, 3]]))]
    elif name == "wrap":
        # segment 1 rises past 2^31 - 1, wraps to -2^31 and comes back
        # into the output over its own bytes, in the check block of 2,048
        # entries it shares with segment 2 (read whole with it); segment 0
        # shares its clean first block, segment 3 starts in a clean one
        length = 3 * T + 1
        a = _ordered_runs(rng, 100)
        up, cu = _ordered_runs(rng, 2500, gap=3)
        back, cb = _ordered_runs(rng, 300, first=40, gap=3)
        wrap = np.array([2**31 - 300, 2**31 - 100, -2**31 + 7, -2**31 + 500,
                         -9000])
        b = (np.concatenate([up, wrap, back]),
             np.concatenate([cu, [5, 80, 5, 3, 4], cb]))
        parts = [a, b, _ordered_runs(rng, 1400, gap=3),
                 _ordered_runs(rng, 5000, gap=1)]
    elif name == "later_wins":
        parts = [_ordered_runs(rng, length // (4 + 2 * s), gap=4 + 4 * s,
                               p_run=0.1) for s in range(3)]
    elif name == "offsets_unsorted":
        st, c = _ordered_runs(rng, 2 * T // 3, gap=10)
        n = st.shape[0]
        seg_off = np.array([-5, 300, 200, n + 100, 50, n], np.int32)
        return (length, 70, st.astype(np.int32), c.astype(np.int32),
                seg_off, rng.integers(0, 256, size=5).astype(np.uint8))
    elif name == "tail":
        st, c = _ordered_runs(rng, T, gap=10)
        junk = rng.integers(-T, 2 * length, size=T // 2)
        start, count, seg_off = _segments([(st, c)])
        return (length, 70,
                np.concatenate([start, junk.astype(np.int32)]),
                np.concatenate([count, rng.integers(-5, 40, size=T // 2)
                                .astype(np.int32)]),
                seg_off, np.array([66], np.uint8))
    elif name in ("segments63", "segments256"):
        k = 63 if name == "segments63" else 256
        parts = [_ordered_runs(rng, int(rng.integers(0, 4 * length // k)),
                               first=int(rng.integers(-50, length)),
                               gap=30) for _ in range(k)]
    elif name == "long_runs":
        length = 8 * T + 3
        parts = [(np.array([5, T + 9, 3 * T + 9, 6 * T + 4, 7 * T + 2]),
                  np.array([T, 2 * T, 3 * T - 5, 7, 4 * T]))]
    elif name == "tiles1100":
        length = 1100 * T
        parts = [_ordered_runs(rng, length // (9 + 5 * s), gap=9 + 10 * s)
                 for s in range(3)]
    start, count, seg_off = _segments(parts)
    values = rng.permutation(np.arange(33, 127))
    values = np.resize(values, len(parts)).astype(np.uint8)
    return length, 70, start, count, seg_off, values


def runs_ref(length, background, start, count, seg_off, seg_value):
    """The generic composition of fill_sorted_runs in numpy: a filled
    buffer, then each segment's runs (as kernels.segment_bounds reads the
    offsets), clipped to it, segment by segment."""
    import numpy as np

    out = np.full(length, background, np.uint8)
    n, top, bounds = start.shape[0], 0, []
    for v in seg_off.tolist():
        top = max(top, min(max(int(v), 0), n))
        bounds.append(top)
    for s in range(seg_value.shape[0]):
        a, z = bounds[s], bounds[s + 1]
        lo = np.maximum(start[a:z].astype(np.int64), 0)
        hi = np.minimum(start[a:z].astype(np.int64)
                        + np.maximum(count[a:z], 0), length)
        w = np.maximum(hi - lo, 0)
        first = np.repeat(lo - (np.cumsum(w) - w), w)
        out[first + np.arange(int(w.sum()))] = seg_value[s]
    return out


def runs_args(case, dev):
    """runs_case's arrays as fill_sorted_runs' arguments on dev."""
    import torch

    length, bg, start, count, seg_off, seg_value = case
    return (length, bg) + tuple(torch.from_numpy(a.copy()).to(dev)
                                for a in (start, count, seg_off, seg_value))


# concat_row_spans' edge cases: the elision's rows (elide_args) of a PE
# grid of 150-byte reads at ov = 0, +127 and -127 on every pair, mixed,
# an odd read count, no reads, pad rows, and 40-byte reads overlapping
# whole (spans of 0 among full ones); then source rows a view with a
# longer stride, spans of 1-3 bytes (more rows a tile than the gather
# stages), source columns clipped both sides, destinations clipped both
# sides, rows whose destinations fall out of order (read whole), a
# length that is no multiple of 16, and 1,100 tiles
CONCAT_CASES = ("ov0", "fwd127", "bwd127", "mixed", "odd_reads",
                "no_reads", "pad_rows", "full_overlap", "strided",
                "short_spans", "src_clip", "dest_clip", "unordered",
                "len_not16", "tiles1100")


def elide_case(kind: str, seed: int = 0):
    """(tseq, ov, n_reads) of a PE grid: tseq (b_cap, L) u8 bases, ov
    (b_cap / 2,) int32 overlaps with the encode's shift clamp applied."""
    import numpy as np

    rng = np.random.default_rng(seed + 20 * CONCAT_CASES.index(kind))
    L, b_cap = (40, 96) if kind == "full_overlap" else (150, 192)
    n_reads = {"odd_reads": 177, "no_reads": 0, "pad_rows": 130}.get(kind,
                                                                     b_cap)
    p = b_cap // 2
    ov = {"ov0": np.zeros(p), "fwd127": np.full(p, 127),
          "bwd127": np.full(p, -127),
          "full_overlap": rng.choice([-L, 0, 12, L], size=p)}.get(
        kind, rng.integers(-L, L + 1, size=p) * (rng.random(p) < 0.7))
    ov = np.where(np.arange(p) < n_reads // 2, ov, 0).astype(np.int32)
    tseq = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=(b_cap, L))
    return tseq, ov, n_reads


def elide_args(tseq, ov, n_reads: int):
    """concat_row_spans' arguments (numpy) for the elision of a PE grid,
    as codec/device_engine.py's _elide makes them: the valid rows, each
    odd row's span past (forward) or before (backward) its overlap."""
    import numpy as np

    b_cap, L = tseq.shape
    drop = np.stack([np.zeros_like(ov), np.abs(ov)], 1).ravel()
    first = np.stack([np.zeros_like(ov), np.maximum(ov, 0)], 1).ravel()
    stored = np.where(np.arange(b_cap) < n_reads, L - drop, 0)
    dest = np.cumsum(stored) - stored
    return (tseq[:n_reads], first[:n_reads].astype(np.int32),
            stored[:n_reads].astype(np.int32),
            dest[:n_reads].astype(np.int32), b_cap * L, ord("G"))


def elide_sort_ref(tseq, ov, n_reads: int):
    """(seq_concat, total_stored) of JAX's elision in numpy
    (repaq_tpu/codec/device_engine.py:594-618): each kept byte keyed by its
    destination, the rest by INT32_MAX, a stable sort of keys and bytes,
    'G' past the stored count."""
    import numpy as np

    b_cap, L = tseq.shape
    aov = np.abs(ov)
    fwd = np.maximum(ov, 0)
    zeros = np.zeros_like(ov)
    drop_row = np.stack([zeros, aov], 1).reshape(-1)
    start_row = np.stack([zeros, fwd], 1).reshape(-1)
    stored_row = np.where(np.arange(b_cap) < n_reads, L - drop_row, 0)
    cum = np.cumsum(stored_row)
    dest_off = cum - stored_row
    total = int(cum[-1])
    i = np.arange(L)[None, :]
    keep = (i >= start_row[:, None]) & (i < (start_row + stored_row)[:, None])
    dest = dest_off[:, None] + i - start_row[:, None]
    keys = np.where(keep, dest, 2**31 - 1).reshape(-1)
    sv = tseq.reshape(-1)[np.argsort(keys, kind="stable")]
    return np.where(np.arange(b_cap * L) < total, sv, ord("G")), total


def concat_case(name: str, tile: int):
    """(src, src_start, span, dest_off, length, background) numpy
    arguments of a CONCAT_CASES case (src possibly a strided view) at a
    tile of `tile` output bytes."""
    import numpy as np

    if name in ("ov0", "fwd127", "bwd127", "mixed", "odd_reads",
                "no_reads", "pad_rows", "full_overlap"):
        return elide_args(*elide_case(name))
    rng = np.random.default_rng(2000 + CONCAT_CASES.index(name))
    width = 150
    rows = {"short_spans": 3 * tile // 2, "tiles1100": 1100 * tile // 120
            }.get(name, 3 * tile // 100)
    buf = rng.integers(0, 256, size=(rows, width + 10), dtype=np.uint8)
    src = buf[:, :width] if name == "strided" else buf[:, 3:width + 3].copy()
    src_start = rng.integers(0, 30, size=rows)
    span = width - src_start - rng.integers(0, 30, size=rows)
    if name == "short_spans":
        src_start = rng.integers(0, 5, size=rows)
        span = rng.integers(0, 4, size=rows)
    if name == "src_clip":
        src_start = rng.integers(-12, width + 12, size=rows)
        span = rng.integers(-3, width + 25, size=rows)
    dest = np.cumsum(np.maximum(span, 0)) - np.maximum(span, 0)
    length = int(dest[-1] + max(span[-1], 0)) + 21
    if name == "dest_clip":
        dest -= 500
        length = int(dest[-1]) - 300
    if name == "unordered":
        # blocks of rows moved out of order, their spans still disjoint
        moved, at = np.empty(rows, np.int64), 0
        blocks = np.array_split(np.arange(rows), 7)
        for k in rng.permutation(len(blocks)):
            b = blocks[k]
            w = np.maximum(span[b], 0)
            moved[b] = at + np.cumsum(w) - w
            at += int(w.sum())
        dest = moved
    if name == "len_not16":
        length = 16 * (int(dest[-1] + span[-1]) // 16) + 13
    return (src, src_start.astype(np.int32), span.astype(np.int32),
            dest.astype(np.int32), length, ord("G"))


def concat_ref(src, src_start, span, dest_off, length, background):
    """concat_row_spans in numpy, a row at a time: each source column in
    [0, width) that the row's span keeps, at its destination inside
    [0, length)."""
    import numpy as np

    out = np.full(length, background, np.uint8)
    width = src.shape[1]
    for r in range(src.shape[0]):
        j = np.arange(max(int(span[r]), 0))
        col = src_start[r] + j
        dst = dest_off[r] + j
        ok = (col >= 0) & (col < width) & (dst >= 0) & (dst < length)
        out[dst[ok]] = src[r, col[ok]]
    return out


def concat_args(case, dev):
    """concat_case's arrays as concat_row_spans' arguments on dev, src
    keeping its row stride."""
    import numpy as np
    import torch

    src, src_start, span, dest_off, length, bg = case
    if src.flags.c_contiguous:
        t = torch.from_numpy(src.copy()).to(dev)
    else:  # a view of the first columns of a wider buffer
        t = torch.from_numpy(src.base.copy()).to(dev)[:, :src.shape[1]]
    return (t,) + tuple(torch.from_numpy(a.copy()).to(dev)
                        for a in (src_start, span, dest_off)) + (length, bg)


def runs_moved(length: int, start, seg_off, seg_value) -> int:
    """The bytes fill_sorted_runs must move: the output written once, start
    and count of every entry inside the segments read once, and the
    offsets and values."""
    from repaq_tpu_torch.ops import kernels as TK

    b = TK.segment_bounds(seg_off, start.shape[0])
    return (length + 8 * (b[-1] - b[0]) + 4 * seg_off.shape[0]
            + seg_value.shape[0])


def concat_moved(src, src_start, span, dest_off, length: int) -> int:
    """The bytes concat_row_spans must move: the output written once, the
    source bytes it copies and three int32 a row read once."""
    import torch

    width = src.shape[1]
    rel = torch.arange(width, device=src.device)[None, :] - \
        src_start.long()[:, None]
    dest = dest_off.long()[:, None] + rel
    kept = ((rel >= 0) & (rel < span.long()[:, None]) & (dest >= 0)
            & (dest < length))
    return length + int(kept.sum()) + 12 * src.shape[0]


def parent_qual_write(length, background, start, count, seg_off, seg_value):
    """The parent's quality write of the same call, as a function of no
    arguments: torch.full of the output, the bin chars with the major
    appended, the per-token value gather by bin id and fill_runs of every
    token (tokens past the segments are bin S - 1 with count 0, as the
    parent's were)."""
    import torch

    from repaq_tpu_torch.ops import kernels as TK

    dev, n = start.device, start.shape[0]
    b = TK.segment_bounds(seg_off, n)
    tok_bin = torch.full((n,), max(seg_value.shape[0] - 1, 0),
                         dtype=torch.int32, device=dev)
    for s in range(seg_value.shape[0]):
        tok_bin[b[s]:b[s + 1]] = s

    def run():
        bin_chars = torch.cat([seg_value, torch.full(
            (1,), background, dtype=torch.uint8, device=dev)])
        qual = torch.full((length,), background, dtype=torch.uint8,
                          device=dev)
        return TK.fill_runs(qual, start, count, bin_chars[tok_bin.long()])
    return run


def parent_elide(tseq, ov, n_reads: int):
    """The parent's _elide: the stored bases of a (b_cap, L) PE grid
    aimed at their destinations, the dropped ones and the pad rows' at a
    spare last byte, in one index_put_ into a 'G'-filled buffer; returns
    (seq_concat, total_stored)."""
    import torch

    dev = tseq.device
    b_cap, L = tseq.shape
    n_cap = b_cap * L
    zeros_p = torch.zeros_like(ov)
    drop_row = torch.stack([zeros_p, ov.abs()], dim=1).reshape(-1)
    start_row = torch.stack([zeros_p, ov.clamp(min=0)], dim=1).reshape(-1)
    rvalid = torch.arange(b_cap, device=dev) < n_reads
    stored_row = torch.where(rvalid, L - drop_row, 0).to(torch.int32)
    cum = torch.cumsum(stored_row, 0, dtype=torch.int32)
    rel = torch.arange(L, dtype=torch.int32, device=dev)[None, :] \
        - start_row[:, None]
    keep = (rel >= 0) & (rel < stored_row[:, None])
    dest = torch.where(keep, (cum - stored_row)[:, None] + rel, n_cap)
    out = torch.full((n_cap + 1,), ord("G"), dtype=torch.uint8, device=dev)
    out[dest.reshape(-1).long()] = tseq.reshape(-1)
    return out[:n_cap], cum[-1]


def take_library(writes, background: int, length: int, dev):
    """(vals, idx) of one torch.take(vals, idx) that computes a sorted-run
    output: vals the written bytes in write order and the background last,
    idx a precomputed int64 source index for every output byte (a later
    write's over an earlier one's). The library call timed as a
    yardstick. writes: [(targets, values)] in write order."""
    import torch

    vals = torch.cat([v for _t, v in writes] + [torch.full(
        (1,), background, dtype=torch.uint8, device=dev)])
    idx = torch.full((length,), vals.shape[0] - 1, dtype=torch.long,
                     device=dev)
    at = 0
    for t, v in writes:
        idx[t] = at + torch.arange(v.shape[0], device=dev)
        at += v.shape[0]
    return vals, idx


def runs_writes(length, start, count, seg_off, seg_value):
    """[(targets, values)] of fill_sorted_runs' writes, segment by segment:
    int64 targets inside [0, length) and their uint8 values."""
    import torch

    from repaq_tpu_torch.ops import kernels as TK

    b = TK.segment_bounds(seg_off, start.shape[0])
    out = []
    for s in range(seg_value.shape[0]):
        st = start[b[s]:b[s + 1]].long()
        lo = st.clamp(min=0)
        hi = (st + count[b[s]:b[s + 1]].long().clamp(min=0)).clamp(
            max=length)
        w = (hi - lo).clamp(min=0)
        first = torch.repeat_interleave(lo - (torch.cumsum(w, 0) - w), w)
        t = first + torch.arange(first.shape[0], device=start.device)
        out.append((t, seg_value[s].expand(t.shape[0])))
    return out


def concat_writes(src, src_start, span, dest_off, length):
    """[(targets, values)] of concat_row_spans' writes."""
    import torch

    width = src.shape[1]
    rel = torch.arange(width, device=src.device)[None, :] - \
        src_start.long()[:, None]
    dest = dest_off.long()[:, None] + rel
    kept = ((rel >= 0) & (rel < span.long()[:, None]) & (dest >= 0)
            & (dest < length))
    return [(dest[kept], src[kept])]


# the PE chunk's calls pe_chunk_calls records, by name
PE_RECORDED = ("concat_row_spans", "pe_encode_pairs", "pe_decode_rows")
_PE_CHUNK_CALLS: dict = {}


def pe_chunk_calls(dev, pairs: int = 40_000) -> dict:
    """_elide's inputs (tseq, ov, n_reads) and the arguments of the
    PE_RECORDED kernels' calls in one PE chunk as the device path makes
    them, each cloned before the call (pe_encode_pairs works in place):
    `pairs` pairs of phase 5's corpus (make_pe_corpus, seed 97; 40,000
    pairs of 150 bp are one -k 12000 chunk, b_cap 98,304) compressed and
    decompressed through repaq_tpu_torch.cli.main with the device engine
    on dev. Made once a device and size."""
    import torch

    from repaq_tpu_torch import cli
    from repaq_tpu_torch.codec import device_engine as DE
    from repaq_tpu_torch.ops import kernels as TK

    key = (str(torch.device(dev)), pairs)
    if key in _PE_CHUNK_CALLS:
        return _PE_CHUNK_CALLS[key]
    work = os.path.join(WORK, "pe_chunk.%d" % os.getpid())
    os.makedirs(work, exist_ok=True)
    fqs = [os.path.join(work, "pe%d.fq" % m) for m in (1, 2)]
    rfq = os.path.join(work, "pe.rfq")
    rec = {name: [] for name in ("elide",) + PE_RECORDED}
    elide = DE._elide
    saved = {name: getattr(TK, name) for name in PE_RECORDED}

    def rec_elide(tseq, ov, n_reads):
        rec["elide"].append((tseq.clone(), ov.clone(), n_reads))
        return elide(tseq, ov, n_reads)

    def recording(name):
        def kernel(*args):
            rec[name].append(tuple(_clone(a) for a in args))
            return saved[name](*args)
        return kernel

    eng = DE.DeviceEngine(dev)
    DE._elide = rec_elide
    for name in PE_RECORDED:
        setattr(TK, name, recording(name))
    try:
        make_pe_corpus(fqs, pairs, 150, seed=97)
        for argv in (["-c", "-i", fqs[0], "-I", fqs[1], "-o", rfq, "-k",
                      "12000"],
                     ["-d", "-i", rfq, "-o", fqs[0] + ".b", "-O",
                      fqs[1] + ".b"]):
            rc = cli.main(argv + ["--engine", "device"], engine=eng.config())
            check(rc == 0, "the PE chunk's %s exited %d" % (argv[0], rc))
        for fq in fqs:
            with open(fq, "rb") as f, open(fq + ".b", "rb") as g:
                check(f.read() == g.read(), "the PE chunk's decode differs "
                      "from its input")
    finally:
        DE._elide = elide
        for name, fn in saved.items():
            setattr(TK, name, fn)
        shutil.rmtree(work, ignore_errors=True)
    check(eng.stats["device_chunks"] == 1 == eng.stats["device_decodes"]
          and all(len(v) == 1 for v in rec.values()),
          "the PE chunk took another path or called its kernels other than "
          "once: %s, %s" % (eng.stats, {k: len(v) for k, v in rec.items()}))
    _PE_CHUNK_CALLS[key] = {k: v[0] for k, v in rec.items()}
    return _PE_CHUNK_CALLS[key]


def sorted_runs_edge_cases(dev) -> int:
    """fill_sorted_runs on every RUNS_CASES case and concat_row_spans on
    every CONCAT_CASES case, placed by the built tile, exact against their
    plain versions and the numpy references, one launch each; returns the
    number of cases."""
    import torch

    from repaq_tpu_torch.ops import kernels as TK

    tile = TK.sorted_runs_tile()
    done = 0
    for kind, names, make, args_of, ref, kern, plain in (
            ("fill_sorted_runs", RUNS_CASES, runs_case, runs_args, runs_ref,
             TK.fill_sorted_runs, TK.fill_sorted_runs_plain),
            ("concat_row_spans", CONCAT_CASES, concat_case, concat_args,
             concat_ref, TK.concat_row_spans, TK.concat_row_spans_plain)):
        for name in names:
            case = make(name, tile)
            args = args_of(case, dev)
            before = TK.launches[kind]
            got = kern(*args)
            torch.cuda.synchronize()
            check(TK.launches[kind] == before + 1, "%s launched %d times on "
                  "%s" % (kind, TK.launches[kind] - before, name))
            check(torch.equal(got, plain(*args))
                  and (got.cpu().numpy() == ref(*case)).all(),
                  "%s differs from its plain version on %s" % (kind, name))
            done += 1
    return done


def sorted_runs_phase(dev) -> dict:
    """fill_sorted_runs and concat_row_spans on their edge cases, then at
    one real SE decode chunk's quality call (chunk_calls) and one real PE
    encode chunk's elision (pe_chunk_calls), exact against their plain
    versions, each timed beside its bound (runs_moved, concat_moved),
    beside one torch.take of precomputed indices (the library call) and,
    in turns, beside the parent's composition (parent_qual_write: torch.full,
    the value gather and fill_runs; parent_elide: the index_put_ into a
    dump slot, timed as the whole elision against the new _elide)."""
    import torch

    from repaq_tpu_torch.codec import device_engine as DE
    from repaq_tpu_torch.ops import kernels as TK

    log("kernels fill_sorted_runs and concat_row_spans exact on %d edge "
        "cases (RUNS_CASES and CONCAT_CASES at %d-byte tiles: no entries or "
        "segments, empty segments, runs across, at and from every tile "
        "edge, clipped both ends, count 0 in and out of order, a length "
        "off 16, a wrapping segment, a later segment over an earlier one, "
        "offsets out of order, entries past the segments, 63 and 256 "
        "segments, runs past a tile, 1,100 tiles; the elision's rows at ov "
        "0, +-127, mixed, odd, none and pad rows, whole overlaps, strided "
        "rows, 1-3 byte spans, clipped columns and destinations, rows out "
        "of order), one launch each"
        % (sorted_runs_edge_cases(dev), TK.sorted_runs_tile()))
    res = {}
    length, bg, start, count, seg_off, seg_value = chunk_calls(dev)[
        "fill_sorted_runs"][0]
    b = TK.segment_bounds(seg_off, start.shape[0])
    label = ("SE decode chunk: %d entries (%d in %d segments), %d bytes"
             % (start.shape[0], b[-1] - b[0], seg_value.shape[0], length))
    vals, idx = take_library(runs_writes(length, start, count, seg_off,
                                         seg_value), bg, length, dev)
    args = (length, bg, start, count, seg_off, seg_value)
    r = held_and_timed(
        "fill_sorted_runs", lambda: TK.fill_sorted_runs(*args),
        lambda: TK.fill_sorted_runs_plain(*args), (), label, plain_runs=3,
        moved=runs_moved(length, start, seg_off, seg_value),
        library=lambda: torch.take(vals, idx))
    del vals, idx
    parent = parent_qual_write(*args)
    check(torch.equal(parent(), TK.fill_sorted_runs(*args)),
          "fill_sorted_runs differs from the parent's composition at %s"
          % label)
    r["in_turns_ms"] = in_turns([("parent", parent), (
        "fill_sorted_runs", lambda: TK.fill_sorted_runs(*args))], label)
    res["fill_sorted_runs"] = dict(r, by_shape={label: r})

    rec = pe_chunk_calls(dev)
    tseq, ov, n_reads = rec["elide"]
    cargs = rec["concat_row_spans"]
    src, src_start, span, dest_off, length, bg = cargs
    label = ("PE encode chunk: %d of %d rows of %d bytes, %d bytes"
             % (src.shape[0], tseq.shape[0], tseq.shape[1], length))
    vals, idx = take_library(concat_writes(*cargs[:5]), bg, length, dev)
    r = held_and_timed(
        "concat_row_spans", lambda: TK.concat_row_spans(*cargs),
        lambda: TK.concat_row_spans_plain(*cargs), (), label, plain_runs=3,
        moved=concat_moved(*cargs[:5]),
        library=lambda: torch.take(vals, idx))
    del vals, idx
    check(all(torch.equal(x, y) for x, y in zip(
        parent_elide(tseq, ov, n_reads), DE._elide(tseq, ov, n_reads))),
        "_elide differs from the parent's at %s" % label)
    r["in_turns_ms"] = in_turns([("parent _elide", lambda: parent_elide(
        tseq, ov, n_reads)), ("_elide", lambda: DE._elide(tseq, ov,
                                                           n_reads))], label)
    res["concat_row_spans"] = dict(r, by_shape={label: r})
    return res


def in_turns(fns: list, label: str, setups: dict | None = None) -> dict:
    """{name: [ms, ms]} of the functions timed by cuda_ms in turns, A B B
    A, logged; setups: name -> cuda_ms' setup of that function."""
    turns = {name: [] for name, _fn in fns}
    for name, fn in fns + fns[::-1]:
        turns[name].append(cuda_ms(fn, setup=(setups or {}).get(name)))
    log("in turns at %s: %s" % (label, "; ".join(
        "%s %s ms" % (name, ", ".join("%.4f" % t for t in ts))
        for name, ts in turns.items())))
    return turns


# bucket_compact's edge cases, each placed by the tile of the route its
# form takes (a mask; ids up to 8 buckets; more): one element, a tile and
# one either side, past 3,000 tiles (an SE grouping's ids; a mask with a
# payload, and past 5,000, more than one wave of its large tiles), more
# tiles than one wave either way, a mask at the
# most small tiles (the switch) and one element past it, where its tiles
# grow (kernels.compact_mask_switch), none and all kept, 8
# buckets (the register route's most) and 9 (the match route), 64 buckets
# with ids past them dropped, a cut at cap, a cap past n and a cap of 0,
# every one of 256 ids in one tile, runs of one bucket across tile edges,
# a mask all kept and cut at cap inside a load step, and a mask laid out
# as a real chunk's decode tokens (a head of 512-element steps all kept or
# 98% kept, then an empty tail); with and without a payload. name ->
# (is_mask, nbuckets)
COMPACT_FORMS = {"n1": (True, 1), "tile-1": (True, 1), "tile": (True, 1),
                 "tile+1": (True, 1), "tiles3001": (False, 4),
                 "mask_tiles3001": (True, 1), "none": (True, 1),
                 "all": (True, 1), "k8": (False, 8), "k9": (False, 9),
                 "k64": (False, 64), "k64_cut": (False, 64),
                 "cap_past_n": (False, 2), "cap0": (True, 1),
                 "k256_tile": (False, 256), "runs": (False, 4),
                 "all_cut": (True, 1), "dense_head": (True, 1),
                 "mask_switch": (True, 1), "mask_switch+1": (True, 1),
                 "mask_tiles5001": (True, 1)}
COMPACT_CASES = tuple(COMPACT_FORMS)
# cases with more tiles than one wave of the mask and register routes' blocks
COMPACT_PAST_WAVE = ("tiles3001", "mask_tiles5001")


def compact_case(name: str, tile: int, switch: int = 1024):
    """(bucket, nbuckets, cap, fill, payload) numpy arrays of a
    COMPACT_CASES case, for a kernel tile of `tile` elements in the route
    of its form (COMPACT_FORMS; a mask's tile below its switch, the most
    such tiles a call takes): bucket bool (one bucket) or uint8 ids,
    payload int32 or None."""
    import numpy as np

    rng = np.random.default_rng(1700 + COMPACT_CASES.index(name))
    n = {"n1": 1, "tile-1": tile - 1, "tile": tile, "tile+1": tile + 1,
         "tiles3001": 3001 * tile + 5, "mask_tiles3001": 3001 * tile + 5,
         "mask_tiles5001": 5001 * tile + 5,
         "mask_switch": switch * tile, "mask_switch+1": switch * tile + 1,
         "k256_tile": tile, "runs": 5 * tile + 1}.get(name, 3 * tile + 5)
    payload = rng.integers(-2**31, 2**31, size=n, dtype=np.int64).astype(
        np.int32)
    is_mask, nbuckets = COMPACT_FORMS[name]
    cap, fill = n, -7
    if name in ("n1", "tile-1", "tile", "tile+1", "cap0", "mask_tiles3001",
                "mask_tiles5001", "mask_switch", "mask_switch+1"):
        bucket = rng.random(n) < 0.5
        cap = 0 if name == "cap0" else n
    elif name in ("none", "all", "all_cut"):
        bucket = np.full(n, name != "none")
        cap = {"none": 100, "all": n, "all_cut": 3 * tile // 2 + 37}[name]
    elif name == "dense_head":
        bucket = np.zeros(n, bool)
        head = 2 * n // 3
        bucket[:head] = rng.random(head) < 0.98
        full = (np.arange(head) // 512) % 2 == 0
        bucket[:head][full] = True
    elif name == "tiles3001":  # an SE chunk's grouping: 3 bins, escape, major
        bucket = rng.choice(5, size=n, p=[0.09, 0.04, 0.009, 0.001, 0.86])
        bucket = bucket.astype(np.uint8)
        cap, fill, payload = int((bucket < 4).sum()), n, None
    elif name in ("k8", "k9", "k64", "k64_cut"):
        bucket = rng.integers(0, nbuckets + 6, size=n).astype(np.uint8)
        if name == "k64_cut":
            cap = int((bucket < 64).sum()) // 2 + 1
    elif name == "cap_past_n":
        bucket = rng.integers(0, 3, size=n).astype(np.uint8)
        cap = n + 1000
    elif name == "k256_tile":
        bucket = rng.permutation(np.arange(n) % 256).astype(np.uint8)
    else:  # runs of one bucket across the tile edges, bucket 4 dropped
        bucket = ((np.arange(n) + tile // 3) // (tile // 2 + 7) % 5).astype(
            np.uint8)
        payload = None
    assert (bucket.dtype == bool) == is_mask
    return bucket, nbuckets, cap, fill, payload


def compact_ref(bucket, nbuckets: int, cap: int, fill: int, payload=None):
    """bucket_compact by numpy: a stable argsort by bucket id, cut to cap
    and padded with fill (payload 0 there); (idx, pay, counts)."""
    import numpy as np

    ids = ((~bucket).astype(np.int64) if bucket.dtype == bool
           else bucket.astype(np.int64))
    order = np.argsort(ids, kind="stable")
    order = order[ids[order] < nbuckets][:cap]
    idx = np.full(cap, fill, np.int32)
    idx[:order.shape[0]] = order
    pay = None
    if payload is not None:
        pay = np.zeros(cap, np.int32)
        pay[:order.shape[0]] = payload[order]
    counts = np.bincount(ids[ids < nbuckets], minlength=nbuckets)
    return idx, pay, counts[:nbuckets].astype(np.int32)


# the caps of compact_seeded: below, at and above the kept count, 0, and
# past n
COMPACT_CAPS = ("below", "at", "above", "zero", "past_n")


def compact_seeded(n: int, nbuckets: int, cap_kind: str, payload: bool):
    """A seeded bucket_compact case of n elements: a bool mask for one
    bucket, else uint8 ids up to nbuckets + 2 (some dropped); a cap of a
    COMPACT_CAPS kind; an int32 payload or None. The same tuple as
    compact_case."""
    import numpy as np

    rng = np.random.default_rng(n + 7 * nbuckets + len(cap_kind) + payload)
    if nbuckets == 1:
        bucket = rng.random(n) < 0.4
        kept = int(bucket.sum())
    else:
        bucket = rng.integers(0, nbuckets + 3, size=n).astype(np.uint8)
        kept = int((bucket < nbuckets).sum())
    cap = {"below": kept // 2, "at": kept, "above": kept + 9, "zero": 0,
           "past_n": n + 100}[cap_kind]
    pay = (rng.integers(-2**31, 2**31, size=n, dtype=np.int64)
           .astype(np.int32) if payload else None)
    return bucket, nbuckets, cap, -3, pay


def compact_args(case, dev):
    """compact_case's arrays as bucket_compact's arguments on dev."""
    import torch

    bucket, nbuckets, cap, fill, payload = case
    return (torch.from_numpy(bucket).to(dev), nbuckets, cap, fill,
            None if payload is None else torch.from_numpy(payload).to(dev))


def compact_moved(bucket, nbuckets: int, cap: int, payload, kept: int) -> int:
    """The bytes bucket_compact must move: every bucket byte read, the
    payload read where an element is kept within cap, idx (and pay) written
    over all of cap, and the counts."""
    k = min(kept, cap)
    return (bucket.shape[0] + 4 * cap + 4 * nbuckets
            + (0 if payload is None else 4 * k + 4 * cap))


def compact_edge_cases(dev) -> int:
    """bucket_compact exact against its plain version and compact_ref on
    every COMPACT_CASES case, placed by the built tile, one launch each;
    returns the number of cases."""
    import numpy as np
    import torch

    from repaq_tpu_torch.ops import kernels as TK

    for name in COMPACT_CASES:
        form = COMPACT_FORMS[name]
        case = compact_case(name, TK.compact_tile(*form),
                            TK.compact_mask_switch())
        n = case[0].shape[0]
        if name in COMPACT_PAST_WAVE:
            tiles = -(-n // TK.compact_tile(*form, n))
            check(tiles > TK.compact_wave(*form, n),
                  "bucket_compact's %s case has %d tiles, not more than one "
                  "wave (%d)" % (name, tiles, TK.compact_wave(*form, n)))
        if name.startswith("mask_switch"):
            check((TK.compact_tile(*form, n) > TK.compact_tile(*form))
                  == name.endswith("+1"), "bucket_compact's %s case is on "
                  "the wrong side of the mask's switch" % name)
        args = compact_args(case, dev)
        before = TK.launches["bucket_compact"]
        got = TK.bucket_compact(*args)
        torch.cuda.synchronize()
        check(TK.launches["bucket_compact"] == before + 1,
              "bucket_compact launched %d times on %s"
              % (TK.launches["bucket_compact"] - before, name))
        want = TK.bucket_compact_plain(*args)
        ref = compact_ref(*case)
        for g, w, r in zip(got, want, ref):
            check((g is None) == (w is None) == (r is None)
                  and (g is None or (torch.equal(g, w) and np.array_equal(
                      g.cpu().numpy(), r))),
                  "bucket_compact differs from its plain version on %s "
                  "(tile %d)" % (name, TK.compact_tile(*form, n)))
        del case, args, got, want, ref
    return len(COMPACT_CASES)


# the bucket_compact calls of one SE chunk, in the order the device path
# makes them: the compress's five, then the decompress's one
COMPACT_CALLS = ("grouping", "quality count >= 2", "N flags",
                 "N count >= 2", "coordinates count >= 2", "decode tokens")
_CHUNK_CALLS: dict = {}
# the kernels whose calls chunk_calls records
RECORDED = ("bucket_compact", "fill_sorted_runs", "fill_runs")


def _clone(a):
    return a.clone() if hasattr(a, "clone") else a


def chunk_calls(dev, reads: int = 80_000) -> dict:
    """{kernel: [its arguments, cloned, call by call]} of the RECORDED
    kernels in one SE chunk as the device path makes them: `reads` reads
    of phase 4's corpus (make_corpus, seed 96; 80,000 reads of 150 bp are
    one -k 12000 chunk) compressed and decompressed through
    repaq_tpu_torch.cli.main with the device engine on dev. Made once a
    device and size."""
    import torch

    from repaq_tpu_torch import cli
    from repaq_tpu_torch.codec.device_engine import DeviceEngine
    from repaq_tpu_torch.ops import kernels as TK

    key = (str(torch.device(dev)), reads)
    if key in _CHUNK_CALLS:
        return _CHUNK_CALLS[key]
    # a directory of this process's own: test processes record in parallel
    work = os.path.join(WORK, "compact_chunk.%d" % os.getpid())
    os.makedirs(work, exist_ok=True)
    fq, rfq, back = (os.path.join(work, f)
                     for f in ("se.fq", "se.rfq", "se.back.fq"))
    calls = {name: [] for name in RECORDED}
    saved = {name: getattr(TK, name) for name in RECORDED}

    def recording(name):
        def kernel(*args):
            calls[name].append(tuple(_clone(a) for a in args))
            return saved[name](*args)
        return kernel

    eng = DeviceEngine(dev)
    for name in RECORDED:
        setattr(TK, name, recording(name))
    try:
        make_corpus([fq], reads, 150, seed=96)
        for argv in (["-c", "-i", fq, "-o", rfq, "-k", "12000"],
                     ["-d", "-i", rfq, "-o", back]):
            rc = cli.main(argv + ["--engine", "device"], engine=eng.config())
            check(rc == 0, "the chunk's %s exited %d" % (argv[0], rc))
    finally:
        for name, fn in saved.items():
            setattr(TK, name, fn)
        shutil.rmtree(work, ignore_errors=True)
    check(eng.stats["device_chunks"] == 1 == eng.stats["device_decodes"],
          "the recorded chunk took another path: %s" % eng.stats)
    check(len(calls["fill_sorted_runs"]) == 1, "the chunk's decode called "
          "fill_sorted_runs %d times, not once"
          % len(calls["fill_sorted_runs"]))
    _CHUNK_CALLS[key] = calls
    return calls


def chunk_compactions(dev, reads: int = 80_000) -> list:
    """The arguments (bucket, nbuckets, cap, fill, payload) of every
    bucket_compact call of chunk_calls' SE chunk, in COMPACT_CALLS
    order."""
    import torch

    calls = [(c + (None,))[:5] for c in chunk_calls(dev, reads)[
        "bucket_compact"]]
    forms = [c[0].dtype == torch.bool for c in calls]
    check(forms == [False] + [True] * 5, "the chunk's bucket_compact calls "
          "are not COMPACT_CALLS' ids and five masks: %s" % forms)
    return calls


def compact_library(bucket, nbuckets: int, cap: int, fill: int,
                    payload=None):
    """The parent's torch.sort of the same keys, as a function of no
    arguments: ids keyed bid << 24 | i (dropped ones INT32_MAX), the sorted
    keys cut to cap; a mask keyed i (fill where unset, fill >= n), the
    sorted keys cut to cap, or with a payload the stable sort's keys and
    the payload gathered by its order."""
    import torch

    n = bucket.shape[0]
    i32 = torch.arange(n, dtype=torch.int32, device=bucket.device)
    if bucket.dtype != torch.bool:
        keys = torch.where(bucket < nbuckets,
                           (bucket.to(torch.int32) << 24) | i32, 2**31 - 1)
        return lambda: torch.sort(keys).values[:cap]
    keys = torch.where(bucket, i32, fill)
    if payload is None:
        return lambda: torch.sort(keys).values[:cap]

    def run():
        sk, order = torch.sort(keys, stable=True)
        return sk, payload[order]
    return run


def compact_shapes(dev, reads: int = 80_000) -> list:
    """(label, bucket, nbuckets, cap, fill, payload, parent) of each of
    chunk_compactions' calls: an SE chunk's grouping by bin, the quality
    stream's count >= 2 with its token fields riding, its N flags, the N
    stream's and the coordinates' count >= 2, and the decode's token
    starts with their windows riding (a dense head, then the buffer's
    empty tail); parent: compact_library's sort of the same keys."""
    import torch

    out = []
    for what, (bucket, k, cap, fill, payload) in zip(
            COMPACT_CALLS, chunk_compactions(dev, reads)):
        if bucket.dtype == torch.bool:
            form = "%d of %d set" % (int(bucket.sum()), bucket.shape[0])
        else:
            form = "%d ids, %d buckets" % (bucket.shape[0], k)
        label = "SE %s: %s, cap %d%s" % (
            what, form, cap, "" if payload is None else ", payload riding")
        out.append((label, bucket, k, cap, fill, payload,
                    compact_library(bucket, k, cap, fill, payload)))
    return out


def compact_traced(forms, dev=None) -> list:
    """The device operations of one bucket_compact call at 3 tiles + 5
    elements of each form in forms, a list of (is_mask, nbuckets), read
    from a CUDA graph capture of it (kernels.captured_ops)."""
    import torch

    from repaq_tpu_torch.ops import kernels as TK

    dev = dev or torch.device("cuda:0")
    return [TK.captured_ops(lambda a=compact_args(compact_seeded(
        3 * TK.compact_tile(*form) + 5, form[1], "at", True), dev):
        TK.bucket_compact(*a)) for form in forms]


def compact_kernel_phase(dev) -> dict:
    """bucket_compact on its edge cases, then at one SE chunk's calls
    (compact_shapes) exact against its plain version, timed beside its
    bound (compact_moved) and beside the parent's sort of the same keys
    (the library call); its device kernels a call counted in a CUDA graph
    capture (kernels.captured_ops: one for a mask, two for ids); then
    timed in turns with the sort: sort, kernel, kernel, sort."""
    import torch

    from repaq_tpu_torch.ops import kernels as TK

    big = (TK.compact_mask_switch() + 1) * TK.compact_tile(True, 1)
    log("kernel bucket_compact exact on %d edge cases (COMPACT_CASES at "
        "the tiles of their routes, mask %d (%d past %d tiles), ids %d, "
        "over 8 ids %d: n = 1, tile - 1, tile, tile + 1, past 3,000 tiles "
        "and past one wave (%d large mask tiles, %d id tiles), at the "
        "mask's switch and one past, none and all kept, all kept cut at "
        "cap, a dense head, 8, 9, 64 and 256 buckets, a cut at cap, cap "
        "past n and 0, runs across tiles), one launch each"
        % (compact_edge_cases(dev), TK.compact_tile(True, 1),
           TK.compact_tile(True, 1, big), TK.compact_mask_switch(),
           TK.compact_tile(False, 4), TK.compact_tile(False, 9),
           TK.compact_wave(True, 1, big), TK.compact_wave(False, 4)))
    res = None
    for label, bucket, k, cap, fill, payload, parent in compact_shapes(dev):
        kernels = TK.captured_ops(lambda: TK.bucket_compact(
            bucket, k, cap, fill, payload))
        kept = int(TK.bucket_compact_plain(bucket, k, 0, fill)[2].sum())

        def kern():
            return tuple(t for t in TK.bucket_compact(bucket, k, cap, fill,
                                                      payload)
                         if t is not None)

        def plain():
            return tuple(t for t in TK.bucket_compact_plain(
                bucket, k, cap, fill, payload) if t is not None)

        r = held_and_timed("bucket_compact", kern, plain, (bucket, payload),
                           label, moved=compact_moved(bucket, k, cap,
                                                      payload, kept),
                           library=parent)
        want = 1 if bucket.dtype == torch.bool else 2
        check(len(kernels) == want, "bucket_compact ran %d device kernels "
              "a call at %s, not %d: %s" % (len(kernels), label, want,
                                            kernels))
        r["device_kernels"] = len(kernels)
        fns = [("sort", parent), ("bucket_compact", kern)]
        turns = {name: [] for name, _fn in fns}
        for name, fn in fns + fns[::-1]:
            turns[name].append(cuda_ms(fn))
        r["in_turns_ms"] = turns
        log("kernel bucket_compact at %s, %d device kernel(s) a call; in "
            "turns: %s" % (label, len(kernels), "; ".join(
                "%s %s ms" % (name, ", ".join("%.4f" % t for t in ts))
                for name, ts in turns.items())))
        if res is None:
            res = dict(r)
            res["by_shape"] = {}
        res["by_shape"][label] = r
    return res


def _overlap_case_makers() -> dict:
    """name -> a maker of (r1, r2) u8 pair rows from an rng, for the
    overlap search's edge cases: the smallest and largest o, minlen 11 and
    12, L1 != L2 both ways, both directions in one pair, rows of one
    repeated byte, bytes 0 and 255, periods, and near misses (every
    candidate failing at its last byte, the search's worst case)."""
    import numpy as np

    acgt = np.frombuffer(b"ACGT", np.uint8)

    def rows(rng, p, l1, l2, alphabet=acgt):
        return (rng.choice(alphabet, size=(p, l1)).astype(np.uint8),
                rng.choice(alphabet, size=(p, l2)).astype(np.uint8))

    def plant(r1, r2, i, o, forward):
        """r1's suffix of o bytes onto r2's prefix, or r2's onto r1's."""
        if forward:
            r2[i, :o] = r1[i, r1.shape[1] - o:]
        else:
            r1[i, :o] = r2[i, r2.shape[1] - o:]

    def mixed(p, l1, l2, alphabet=acgt, lengths=None):
        """A quarter each: forward, backward, none, and both (forward
        planted last); o from `lengths` or 1..minlen."""
        def make(rng):
            r1, r2 = rows(rng, p, l1, l2, alphabet)
            minlen = min(l1, l2)
            for i in range(p):
                o = int(rng.choice(lengths) if lengths is not None
                        else rng.integers(1, minlen + 1))
                if i % 4 in (1, 3):
                    plant(r1, r2, i, int(rng.integers(1, minlen // 2 + 1))
                          if i % 4 == 3 else o, False)
                if i % 4 in (0, 3):
                    plant(r1, r2, i, o if i % 4 == 0
                          else int(rng.integers(1, minlen // 2 + 1)), True)
            return r1, r2
        return make

    def one_byte(rng):
        p, L = 64, 150
        v = rng.integers(0, 256, size=p).astype(np.uint8)
        w = np.where(np.arange(p) % 2 == 0, v, v ^ 0x5A).astype(np.uint8)
        v[:4], w[:4] = (0, 255, 0, 255), (0, 255, 255, 0)
        return (np.repeat(v[:, None], L, 1), np.repeat(w[:, None], L, 1))

    def periodic(rng):
        p, L = 128, 150
        r1, r2 = rows(rng, p, L, L)
        for i in range(p):
            unit = rng.choice(acgt, size=2 + i % 5)
            tile = np.resize(unit, L + 8)
            r1[i] = tile[:L]
            r2[i] = tile[i % 7: i % 7 + L]
        return r1, r2

    def near_miss(rng):
        """Rows A..AC / A..AG (every candidate of both directions fails at
        its last byte: ov 0), and planted overlaps with one byte changed."""
        p, L = 64, 150
        r1, r2 = rows(rng, p, L, L)
        for i in range(p):
            if i % 2 == 0:
                r1[i], r2[i] = ord("A"), ord("A")
                r1[i, -1], r2[i, -1] = ord("C"), ord("G")
                if i % 4 == 2:  # the same from the other side
                    r1[i, 0], r2[i, 0] = ord("C"), ord("G")
                    r1[i, -1], r2[i, -1] = ord("A"), ord("A")
            else:
                o = int(rng.integers(12, L + 1))
                plant(r1, r2, i, o, i % 4 == 1)
                k = int(rng.integers(0, o))
                if i % 4 == 1:
                    r2[i, k] = ord("N")
                else:
                    r1[i, k] = ord("N")
        return r1, r2

    def o_limits(rng):
        """o = 12 and 11 both ways, and o = minlen both ways (L1 != L2)."""
        p, l1, l2 = 128, 150, 120
        r1, r2 = rows(rng, p, l1, l2)
        for i in range(p):
            plant(r1, r2, i, (12, 11, 120, 12)[i % 4], i % 8 < 4)
        return r1, r2

    every = np.arange(256, dtype=np.uint8)
    return {
        "l1_above_l2": mixed(512, 150, 101),
        "l1_below_l2": mixed(512, 77, 150),
        "minlen_11": mixed(64, 11, 150, lengths=[11]),
        "minlen_12": mixed(128, 12, 12, lengths=[12]),
        "minlen_13": mixed(128, 13, 200, lengths=[12, 13]),
        "o_12_and_minlen": o_limits,
        "short_overlaps": mixed(256, 150, 150, lengths=[11, 12, 13, 14, 15]),
        "bytes_0_255": mixed(512, 150, 150, alphabet=every),
        "bytes_0_and_255_only": mixed(256, 150, 150,
                                      alphabet=np.array([0, 255], np.uint8)),
        "one_byte_rows": one_byte,
        "periodic": periodic,
        "near_miss": near_miss,
        "one_pair": mixed(1, 150, 150, lengths=[150]),
    }


OVERLAP_CASES = sorted(_overlap_case_makers())


def overlap_case(name: str):
    """(r1, r2), u8 pair rows, of the overlap edge case `name` (in
    OVERLAP_CASES), from a seed of its own."""
    import numpy as np

    seed = OVERLAP_CASES.index(name) + 1391
    return _overlap_case_makers()[name](np.random.default_rng(seed))


def pe_overlap_grid(seed: int = 1391):
    """The (2 * PE_PAIR_CAP, 150) u8 grid the PE step searches in one
    chunk: PE_PAIRS pairs of make_pe_corpus's reads, R2 reverse-
    complemented, pairs of rows interleaved, and 'G' rows past them."""
    import numpy as np

    r1, r2 = pe_reads(np.random.default_rng(seed), PE_PAIRS, 150)
    comp = np.arange(256, dtype=np.uint8)
    comp[np.frombuffer(b"ACGT", np.uint8)] = np.frombuffer(b"TGCA", np.uint8)
    grid = np.full((2 * PE_PAIR_CAP, 150), ord("G"), dtype=np.uint8)
    grid[0: 2 * PE_PAIRS: 2] = r1
    grid[1: 2 * PE_PAIRS: 2] = comp[r2[:, ::-1]]
    return grid


def overlap_edge_cases(dev) -> int:
    """overlap_pairs exact against its plain version on every
    OVERLAP_CASES input, one launch a call, as given and as the strided
    views of one interleaved grid (where L1 == L2) or of a wider buffer;
    an empty input launches nothing. Returns the call count."""
    import torch

    from repaq_tpu_torch.ops import kernels as TK

    calls = []
    for name in OVERLAP_CASES:
        r1, r2 = (torch.from_numpy(a).to(dev) for a in overlap_case(name))
        calls.append((name, r1, r2))
        p, l1 = r1.shape
        l2 = r2.shape[1]
        if l1 == l2:
            grid = torch.stack([r1, r2], 1).reshape(2 * p, l1)
            calls.append((name + ", interleaved views", grid[0::2],
                          grid[1::2]))
        wide = torch.zeros((p, l1 + l2 + 3), dtype=torch.uint8, device=dev)
        wide[:, 1:1 + l1] = r1
        wide[:, 3 + l1:] = r2
        calls.append((name + ", views at odd offsets", wide[:, 1:1 + l1],
                      wide[:, 3 + l1:]))
    for what, r1, r2 in calls:
        before = TK.launches["overlap_pairs"]
        got = TK.overlap_pairs(r1, r2)
        torch.cuda.synchronize()
        check(TK.launches["overlap_pairs"] == before + 1,
              "overlap_pairs took other than one launch")
        want = TK.overlap_pairs_plain(r1, r2)
        check(torch.equal(got, want), "overlap_pairs differs from its plain "
              "version on %s (%d of %d pairs)"
              % (what, int((got != want).sum()), r1.shape[0]))
    empty = torch.zeros((0, 150), dtype=torch.uint8, device=dev)
    before = TK.launches["overlap_pairs"]
    check(TK.overlap_pairs(empty, empty).shape == (0,)
          and TK.launches["overlap_pairs"] == before,
          "overlap_pairs launched on no pairs")
    return len(calls)


def overlap_kernel_phase(dev) -> dict:
    """overlap_pairs exact on the edge cases, then exact and timed on the
    strided views of a PE chunk's grid (PE_PAIR_CAP pairs of 150 bytes)."""
    import torch

    from repaq_tpu_torch.ops import kernels as TK

    log("kernel overlap_pairs exact on %d edge-case calls (%s; each as "
        "given and as strided views), one launch each"
        % (overlap_edge_cases(dev), ", ".join(OVERLAP_CASES)))
    grid = torch.from_numpy(pe_overlap_grid()).to(dev)
    r1, r2 = grid[0::2], grid[1::2]
    shape = ("strided views of a PE chunk's grid: %d pairs of 150 bytes "
             "(%d of reads, the rest 'G')" % (PE_PAIR_CAP, PE_PAIRS))
    res = held_and_timed("overlap_pairs", lambda: TK.overlap_pairs(r1, r2),
                         lambda: TK.overlap_pairs_plain(r1, r2), (r1, r2),
                         shape, plain_runs=3)
    ov = TK.overlap_pairs(r1, r2)[:PE_PAIRS]
    res["forward_share"] = float((ov > 0).float().mean())
    res["backward_share"] = float((ov < 0).float().mean())
    log("kernel overlap_pairs at the PE chunk: %.2f%% of pairs forward, "
        "%.2f%% backward" % (100 * res["forward_share"],
                             100 * res["backward_share"]))
    check(res["forward_share"] > 0.01 and res["backward_share"] > 0.01,
          "overlap_pairs: the PE chunk takes one search branch only")
    return res


# ---------------------------------------------------------------------------
# the PE pair tiles (pe_encode_pairs, pe_decode_rows)
# ---------------------------------------------------------------------------

# the pair kernels' edge cases, each (L, pairs of the grid, pairs with reads,
# overlap shift, search, what to plant), the counts in tiles t of the
# encode at that L: pad rows past the reads, an odd pair count (and an odd
# number of pairs in the grid), one pair, three tiles and one pair, shifts
# that put ov + shift at +-127 and +-128, whole-row overlaps (|ov| = L) and
# o = 12, L not a multiple of 4 or 16 (37, 13), L = 12 and 11 (no
# candidate), every byte value, no search (a header without the overlap
# flag), tiles of very different elision in turn, the nBaseQual N restore,
# a grid whose bytes are no multiple of 16, long reads (tiles of 4 and 1
# pairs); PAIR_LONG_CASES only on the card: a tile of one pair in one
# stage, rows too long for a tile (the encode's long route, the decode's
# direct route) and the engine's longest read
PAIR_FORMS = {
    "pad_rows": (150, lambda t: 3 * t, lambda t: 2 * t + 5, -24, True,
                 "mixed"),
    "odd_pairs": (150, lambda t: 2 * t + 1, lambda t: 2 * t + 1, 0, True,
                  "mixed"),
    "one_pair": (150, lambda t: 1, lambda t: 1, 0, True, "fwd_whole"),
    "tiles3+1": (150, lambda t: 3 * t + 1, lambda t: 3 * t + 1, -24, True,
                 "mixed"),
    "clamp_plus10": (150, lambda t: 2 * t, lambda t: 2 * t, 10, True,
                     "clamp_plus10"),
    "clamp_minus24": (150, lambda t: 2 * t, lambda t: 2 * t, -24, True,
                      "clamp_minus24"),
    "whole_rows": (40, lambda t: 2 * t, lambda t: 2 * t, 0, True, "whole"),
    "l37": (37, lambda t: 2 * t + 3, lambda t: 2 * t + 2, 0, True, "mixed"),
    "l13": (13, lambda t: t + 1, lambda t: t + 1, 0, True, "mixed"),
    "l12": (12, lambda t: t + 1, lambda t: t + 1, 0, True, "mixed"),
    "l11": (11, lambda t: t + 1, lambda t: t + 1, 0, True, "mixed"),
    "bytes_all": (150, lambda t: t + 3, lambda t: t + 3, 0, True, "bytes"),
    "no_search": (150, lambda t: 2 * t, lambda t: 2 * t - 3, -24, False,
                  "mixed"),
    "straddle": (150, lambda t: 4 * t, lambda t: 4 * t, 0, True,
                 "straddle"),
    "nbq": (150, lambda t: 2 * t, lambda t: 2 * t - 1, -24, True, "nbq"),
    "not16": (37, lambda t: 3, lambda t: 3, 0, True, "mixed"),
    "l1000": (1000, lambda t: 2 * t + 1, lambda t: 2 * t + 1, -24, True,
              "mixed"),
    "l5000": (5000, lambda t: 3, lambda t: 3, -24, True, "mixed"),
}
PAIR_LONG_FORMS = {
    "l20000": (20000, lambda t: 3, lambda t: 3, -24, True, "mixed"),
    "l40000": (40000, lambda t: 2, lambda t: 2, 0, True, "mixed"),
    "l65535": (65535, lambda t: 1, lambda t: 1, 0, True, "fwd_whole"),
}
PAIR_CASES = tuple(PAIR_FORMS)
PAIR_LONG_CASES = tuple(PAIR_LONG_FORMS)


def comp_np():
    """(256,) u8: codec/vectorized.py's _COMP, the complement the PE
    kernels write (ACGT and acgt to TGCA, every other byte to 'N')."""
    import numpy as np

    comp = np.full(256, ord("N"), np.uint8)
    comp[np.frombuffer(b"AaTtCcGg", np.uint8)] = np.frombuffer(b"TTAAGGCC",
                                                               np.uint8)
    return comp


def _planted(kind: str, p: int, L: int, rng) -> int:
    """The overlap planted into pair p (in transformed rows): > 0 forward,
    < 0 backward, 0 none."""
    if kind == "mixed":
        return int((0, 1, -1, 0)[p % 4] * rng.integers(1, L + 1))
    if kind == "whole":
        return (L, -L, 12, -12, 0)[p % 5]
    if kind == "fwd_whole":
        return L
    if kind == "clamp_plus10":  # |ov + 10| = 127 kept, 128 cut
        return (117, 118, -137, -138, 12, -12, 150, 0)[p % 8]
    if kind == "clamp_minus24":  # |ov - 24| = 127 kept, 128 cut
        return (-103, -104, 150, 149, 12, -12, 0, 60)[p % 8]
    if kind == "straddle":  # tiles of 8 pairs in turn: whole, none, -whole
        return (L, 0, -L, 0)[(p // 8) % 4]
    return 0


def pair_case(name: str, tile_of=lambda L: 32):
    """(seq_mat, qual_mat, n_pairs, shift, search, nbq) of a PAIR_CASES or
    PAIR_LONG_CASES case as numpy: raw (rows, L) u8 grids whose pair rows
    the encode transforms (rows past 2 n_pairs 'G' and the major 'F'),
    overlaps planted in the transformed rows; nbq the quality byte that
    restores 'N' in the decode (None but for the nbq case). tile_of(L):
    pairs a tile of the encode at L."""
    import numpy as np

    forms = dict(PAIR_FORMS, **PAIR_LONG_FORMS)
    L, grid_of, reads_of, shift, search, kind = forms[name]
    t = tile_of(L)
    pcap, n = grid_of(t), reads_of(t)
    rng = np.random.default_rng(2020 + sorted(forms).index(name))
    rows = 2 * pcap
    if kind == "bytes":
        tseq = rng.integers(0, 256, size=(rows, L), dtype=np.uint8)
        tseq[0, :] = np.arange(L) % 256
        tseq[1, :] = (np.arange(L) + 150) % 256
    else:
        tseq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(rows, L))
        tseq[rng.random((rows, L)) < 0.01] = ord("N")
        for p in range(n):
            o = _planted(kind, p, L, rng)
            if o > 0:
                tseq[2 * p + 1, :o] = tseq[2 * p, L - o:]
            elif o < 0:
                tseq[2 * p, :-o] = tseq[2 * p + 1, L + o:]
    seq = tseq.copy()
    if kind != "bytes":  # comp is its own inverse on ACGTN
        seq[1::2] = comp_np()[tseq[1::2, ::-1]]
    qual = rng.choice(np.frombuffer(NOVA_QUALS, np.uint8), size=(rows, L),
                      p=NOVA_P)
    nbq = None
    if kind == "nbq":  # '#' exactly where the base is 'N'
        nbq = ord("#")
        qual[qual == nbq] = ord(",")
        qual[seq == ord("N")] = nbq
    seq[2 * n:] = ord("G")
    qual[2 * n:] = ord("F")
    return (seq.astype(np.uint8), qual.astype(np.uint8), n, shift, search,
            nbq)


def decode_inputs(tseq, tqual, ov, n_pairs: int, search: bool, nbq=None):
    """(stored, qual, tables) numpy of the decode of an encoded PE grid, as
    DeviceEngine's PE decode makes them: the transformed rows' stored
    spans concatenated (odd rows drop |ov| bases, rows past the reads store
    nothing), 'A' past them (the unpack of zero padding) and where the
    quality restores 'N'; qual the transformed quality grid, flat; tables
    (4, rows) int32, or None without search (every row stores L bases)."""
    import numpy as np

    rows, L = tseq.shape
    b = 2 * n_pairs
    flat = tseq.copy()
    if nbq is not None:
        flat[tqual == nbq] = ord("A")
    stored = np.full(rows * L, ord("A"), np.uint8)
    if not search:
        stored[:b * L] = flat[:b].reshape(-1)
        return stored, tqual.reshape(-1).copy(), None
    ovp = ov[:n_pairs].astype(np.int64)
    span = np.full(b, L, np.int64)
    span[1::2] -= np.abs(ovp)
    off = np.cumsum(span) - span
    first = np.zeros(b, np.int64)
    first[1::2] = np.maximum(ovp, 0)
    for r in range(b):
        stored[off[r]:off[r] + span[r]] = flat[r, first[r]:first[r] + span[r]]
    tab = np.zeros((4, rows), np.int32)
    tab[0, :b] = off
    tab[1, 1:b:2] = np.maximum(ovp, 0)
    tab[2, 1:b:2] = np.maximum(-ovp, 0)
    tab[3, 1:b:2] = off[0:b:2]
    return stored, tqual.reshape(-1).copy(), tab


def wild_tables(rows: int, L: int, n_stored: int, seed: int = 2040):
    """(4, rows) int32 tables of no real chunk: offsets and overlaps
    anywhere in int32 or near the stored range's ends, so indices clamp,
    wrap and fall outside a tile's staged range."""
    import numpy as np

    rng = np.random.default_rng(seed)
    near = rng.integers(-2 * L, n_stored + 2 * L, size=(4, rows))
    far = rng.integers(-2**31, 2**31, size=(4, rows))
    return np.where(rng.random((4, rows)) < 0.8, near, far).astype(np.int32)


def pairs_moved(rows: int, L: int) -> int:
    """The bytes pe_encode_pairs must move: the seq grid and the odd qual
    rows read, the odd rows of both written, ov (int32 a pair) written."""
    return rows * L + (rows // 2) * L + 2 * (rows // 2) * L + 4 * (rows // 2)


def rows_moved(stored, qual, tables, L: int) -> int:
    """The bytes pe_decode_rows must move: each stored byte some row reads
    once, the quality grid and the tables read, the seq and quality grids
    written."""
    import torch

    rows = qual.shape[0] // L
    seen = torch.zeros(stored.shape[0], dtype=torch.bool,
                       device=stored.device)
    if tables is None:
        seen[:min(rows * L, stored.shape[0])] = True
    else:  # the sources of the real chunk's rows (no int32 wrap), marked
        so, f, w, prev = (t[:, None].long() for t in tables)
        i = torch.arange(L, device=stored.device)[None, :]
        odd = (torch.arange(rows, device=stored.device) % 2 == 1)[:, None]
        s = torch.where(i < f, so - f + i,
                        torch.where(i >= L - w, prev + i - (L - w),
                                    so + i - f))
        s = torch.where(odd, s, so + i).clamp(0, stored.shape[0] - 1)
        seen[s.reshape(-1)] = True
    return (int(seen.sum()) + qual.shape[0]
            + (0 if tables is None else 16 * rows) + 2 * qual.shape[0])


def parent_pe_encode(seq_mat, qual_mat, n_pairs: int, shift: int,
                     search: bool):
    """The parent's PE encode pair work, as a function of no arguments
    returning (ov, tseq, tqual): the revcomp's clones, flips, LUT gather
    and row assigns, the overlap_pairs launch on the transformed rows'
    views and the clamp's elementwise kernels."""
    import torch

    from repaq_tpu_torch.ops import kernels as TK

    dev = seq_mat.device
    comp = TK.comp_table(dev)
    p_cap = seq_mat.shape[0] // 2

    def run():
        tseq = seq_mat.clone()
        tseq[1::2] = comp[seq_mat[1::2].flip(1).long()]
        tqual = qual_mat.clone()
        tqual[1::2] = qual_mat[1::2].flip(1)
        ov = torch.zeros(p_cap, dtype=torch.int32, device=dev)
        if search:
            found = TK.overlap_pairs(tseq[0::2], tseq[1::2])
            pvalid = torch.arange(p_cap, device=dev) < n_pairs
            shifted = found + shift
            ov = torch.where(pvalid & (shifted <= 127) & (shifted >= -127),
                             found, 0)
        return ov, tseq, tqual
    return run


def parent_pe_decode(stored, qual, tables, L: int, nbq):
    """The parent's PE decode work after the quality decode, as a function
    of no arguments returning its payload: _expand where tables are given
    (an int32 index grid by three wheres, a clamp, an int64 gather), the N
    where, the revcomp's flips, LUT gather and row assigns (in place on
    qual, and on stored without tables, as the parent's were on their
    step's tensors) and the payload's torch.cat."""
    import torch

    from repaq_tpu_torch.ops import kernels as TK

    dev = qual.device
    comp = TK.comp_table(dev)

    def run():
        seq = stored
        if tables is not None:
            so, f, w, prev = (t[:, None] for t in tables)
            i = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
            odd = (torch.arange(so.shape[0], device=dev) % 2 == 1)[:, None]
            src = torch.where(i < f, so - f + i,
                              torch.where(i >= L - w, prev + i - (L - w),
                                          so + i - f))
            src = torch.where(odd, src, so + i).reshape(-1)
            seq = stored[src.clamp(0, stored.shape[0] - 1).long()]
        if nbq is not None:
            seq = torch.where(qual == nbq, ord("N"), seq)
        sm = seq.view(-1, L)
        sm[1::2] = comp[sm[1::2].flip(1).long()]
        qm = qual.view(-1, L)
        qm[1::2] = qm[1::2].flip(1)
        return torch.cat([seq, qual])
    return run


def pair_edge_cases(dev, names=PAIR_CASES + PAIR_LONG_CASES) -> int:
    """pe_encode_pairs on every case in names (PAIR_CASES, PAIR_LONG_CASES)
    placed by the built encode tile, and pe_decode_rows on each case's
    encoded grid (decode_inputs: its tables, or none without search; the
    case's nbq), on the same grid with nbq ':' and, for pad_rows, with
    wild_tables; each one launch, exact against the plain version (ov and
    both grids; the whole payload), the decode giving the case's rows
    back where it can (not on every byte value, whose complement is not
    its own inverse). Returns the number of calls."""
    import numpy as np
    import torch

    from repaq_tpu_torch.ops import kernels as TK

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def one_launch(name, fn):
        before = TK.launches[name]
        got = fn()
        torch.cuda.synchronize()
        check(TK.launches[name] == before + 1, "%s launched %d times"
              % (name, TK.launches[name] - before))
        return got

    calls = 0
    for name in names:
        seq, qual, n, shift, search, nbq = pair_case(name, TK.pe_pair_tile)
        L = seq.shape[1]
        s1, q1 = t(seq), t(qual)
        ov = one_launch("pe_encode_pairs", lambda: TK.pe_encode_pairs(
            s1, q1, n, shift, search))
        s2, q2 = t(seq), t(qual)
        want = TK.pe_encode_pairs_plain(s2, q2, n, shift, search)
        check(torch.equal(ov, want) and torch.equal(s1, s2)
              and torch.equal(q1, q2), "pe_encode_pairs differs from its "
              "plain version on %s (%d of %d pairs)"
              % (name, int((ov != want).sum()), ov.shape[0]))
        calls += 1
        stored, qflat, tab = decode_inputs(s1.cpu().numpy(), q1.cpu().numpy(),
                                           ov.cpu().numpy(), n, search, nbq)
        variants = [(tab, nbq, name != "bytes_all"), (tab, ord(":"), False)]
        if name == "pad_rows":
            variants.append((wild_tables(seq.shape[0], L, stored.shape[0]),
                             None, False))
        for tb, q_nbq, round_trip in variants:
            args = (t(stored), t(qflat), None if tb is None else t(tb), L,
                    q_nbq)
            got = one_launch("pe_decode_rows",
                             lambda: TK.pe_decode_rows(*args))
            check(torch.equal(got, TK.pe_decode_rows_plain(*args)),
                  "pe_decode_rows differs from its plain version on %s "
                  "(tables %s, nbq %s)" % (name, "none" if tb is None else
                                           "given", q_nbq))
            if round_trip:
                b = 2 * n * L
                out = got.cpu().numpy()
                check((out[:b] == seq[:2 * n].reshape(-1)).all() and
                      (out[seq.size:seq.size + b]
                       == qual[:2 * n].reshape(-1)).all(),
                      "pe_decode_rows does not give %s's reads back" % name)
            calls += 1
    return calls


def pairs_traced(rec=None) -> list:
    """[the device operations of one pe_encode_pairs call, of one
    pe_decode_rows call] at a real PE chunk's calls (rec, pe_chunk_calls'
    record; made here when None), read from CUDA graph captures of them
    (kernels.captured_ops). The encode works in place: it is handed copies
    of the grids."""
    import torch

    from repaq_tpu_torch.ops import kernels as TK

    rec = rec or pe_chunk_calls(torch.device("cuda:0"))
    seq_mat, qual_mat, *rest = rec["pe_encode_pairs"]
    enc = (seq_mat.clone(), qual_mat.clone(), *rest)
    dec = rec["pe_decode_rows"]
    return [TK.captured_ops(lambda: TK.pe_encode_pairs(*enc)),
            TK.captured_ops(lambda: TK.pe_decode_rows(*dec))]


def pair_kernel_phase(dev) -> dict:
    """pe_encode_pairs and pe_decode_rows on their edge cases
    (pair_edge_cases), then at one real PE chunk's calls recorded through
    cli.main (pe_chunk_calls): exact against their plain versions and the
    parent's compositions, each one device kernel a call (pairs_traced:
    no torch kernel in the work the parent's enc.revcomp, enc.overlap,
    dec.expand and dec.revcomp ranges held), each timed beside its bound
    (pairs_moved, rows_moved), its plain version and, in turns, the
    parent's composition (parent_pe_encode, parent_pe_decode). The encode
    works in place, so each timed call gets its grids back first,
    untimed."""
    import torch

    from repaq_tpu_torch.ops import kernels as TK

    log("kernels pe_encode_pairs and pe_decode_rows exact on %d edge-case "
        "calls (PAIR_CASES and PAIR_LONG_CASES at the built encode tile, "
        "%d pairs at 150 bp: %s; each grid decoded as encoded, with nbq "
        "':', and with wild tables once), one launch each"
        % (pair_edge_cases(dev), TK.pe_pair_tile(150),
           ", ".join(PAIR_CASES + PAIR_LONG_CASES)))
    rec = pe_chunk_calls(dev)
    traced = pairs_traced(rec)
    for name, kernels in zip(("pe_encode_pairs", "pe_decode_rows"), traced):
        check(len(kernels) == 1, "%s ran %d device kernels a call, not 1: %s"
              % (name, len(kernels), kernels))
    log("kernels pe_encode_pairs and pe_decode_rows: one device kernel a "
        "call at the real PE chunk (%s)" % "; ".join(k[0] for k in traced))
    res = {}

    seq_mat, qual_mat, n_pairs, shift, search = rec["pe_encode_pairs"]
    rows, L = seq_mat.shape
    label = ("PE encode chunk: %d of %d pairs of %d bytes, shift %d%s"
             % (n_pairs, rows // 2, L, shift, "" if search else ", no search"))
    s1, q1, s2, q2 = (x.clone() for x in (seq_mat, qual_mat) * 2)
    got = (TK.pe_encode_pairs(s1, q1, n_pairs, shift, search), s1, q1)
    want = (TK.pe_encode_pairs_plain(s2, q2, n_pairs, shift, search), s2, q2)
    parent = parent_pe_encode(seq_mat, qual_mat, n_pairs, shift, search)
    err = max(max_abs_err(got, want), max_abs_err(got, parent()))
    check(err == 0, "pe_encode_pairs differs from its plain version or the "
          "parent's composition at %s" % label)
    grids = (seq_mat.clone(), qual_mat.clone())

    def restore():
        grids[0].copy_(seq_mat)
        grids[1].copy_(qual_mat)

    def kern():
        return TK.pe_encode_pairs(*grids, n_pairs, shift, search)

    def plain():
        return TK.pe_encode_pairs_plain(*grids, n_pairs, shift, search)

    ms = cuda_ms(kern, setup=restore)
    r = {"max_abs_err": err, "ms": ms,
         "plain_ms": cuda_ms(plain, runs=3, setup=restore),
         **bound_fields(pairs_moved(rows, L), ms), "library_ms": None,
         "device_kernels": len(traced[0])}
    log("kernel %-21s exact at %s: %.4f ms (bound %.4f ms, %.0f%%), plain "
        "torch %.4f ms" % ("pe_encode_pairs", label, ms, r["bound_ms"],
                           100 * r["share_of_bound"], r["plain_ms"]))
    r["in_turns_ms"] = in_turns([("parent", parent),
                                 ("pe_encode_pairs", kern)], label,
                                setups={"pe_encode_pairs": restore})
    res["pe_encode_pairs"] = dict(r, by_shape={label: dict(r)})
    del grids, s1, q1, s2, q2, got, want

    stored, qual, tables, L, nbq = rec["pe_decode_rows"]
    label = ("PE decode chunk: %d rows of %d bytes from %d stored bytes, "
             "tables %s, nbq %s" % (qual.shape[0] // L, L, stored.shape[0],
                                    "given" if tables is not None else "none",
                                    nbq))
    args = (stored, qual, tables, L, nbq)
    r = held_and_timed("pe_decode_rows", lambda: TK.pe_decode_rows(*args),
                       lambda: TK.pe_decode_rows_plain(*args), (), label,
                       plain_runs=3, moved=rows_moved(stored, qual, tables,
                                                      L))
    check(torch.equal(parent_pe_decode(stored.clone(), qual.clone(), tables,
                                       L, nbq)(), TK.pe_decode_rows(*args)),
          "pe_decode_rows differs from the parent's composition at %s"
          % label)
    r["device_kernels"] = len(traced[1])
    r["in_turns_ms"] = in_turns([
        ("parent", parent_pe_decode(stored.clone(), qual.clone(), tables, L,
                                    nbq)),
        ("pe_decode_rows", lambda: TK.pe_decode_rows(*args))], label)
    res["pe_decode_rows"] = dict(r, by_shape={label: dict(r)})
    return res


def frontend_ragged_cases(dev) -> list:
    """The frontend kernel exact against its plain version at n % 4 = 1,
    2, 3 with 'N' and the major qual in the tail; returns the sizes."""
    import numpy as np
    import torch

    from repaq_tpu_torch.ops import kernels as TK

    rng = np.random.default_rng(4)
    bins = torch.tensor(list(b"#,:"), dtype=torch.uint8, device=dev)
    sizes = [1, 2, 3, 17, 4 * 1001 + 2, (1 << 20) + 3, PE_BASES - 1]
    for n in sizes:
        seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=n)
        qual = rng.choice(np.frombuffer(NOVA_QUALS, np.uint8), size=n,
                          p=NOVA_P)
        seq[-1], qual[-1] = ord("N"), ord("F")
        if n > 1:
            seq[-2], qual[-2] = ord("N"), ord("#")
        args = (torch.from_numpy(seq).to(dev), torch.from_numpy(qual).to(dev),
                bins, ord("F"))
        got = TK.encode_frontend(*args)
        want = TK.encode_frontend_plain(*args)
        torch.cuda.synchronize()
        check(max_abs_err(got, want) == 0 and got[0].shape[0] == (n + 3) // 4,
              "encode_frontend differs from its plain version at n=%d" % n)
    return sizes


UNPACK_TAILS = (0, 1, 15, 16, 17, 4096 + 13)


def unpack_cases(dev, packed) -> list:
    """The unpack kernel exact against its plain version on every tail
    length (m % 4 bytes past its last word, m % 16 past a thread's four
    words), one launch each but none for m = 0, and at packed's size into
    a (4m + 1)-byte buffer, whose last byte it must leave alone; returns
    the lengths."""
    import numpy as np
    import torch

    from repaq_tpu_torch.ops import kernels as TK

    rng = np.random.default_rng(127)
    for m in UNPACK_TAILS:
        p = torch.from_numpy(rng.integers(0, 256, size=m,
                                          dtype=np.uint8)).to(dev)
        before = TK.launches["unpack_bases"]
        got = TK.unpack_bases(p)
        torch.cuda.synchronize()
        check(TK.launches["unpack_bases"] == before + (m > 0)
              and torch.equal(got, TK.unpack_bases_plain(p)),
              "unpack_bases differs from its plain version at m=%d" % m)
    m = packed.shape[0]
    buf = torch.full((4 * m + 1,), 7, dtype=torch.uint8, device=dev)
    got = TK.unpack_bases(packed, out=buf)
    torch.cuda.synchronize()
    check(torch.equal(got, TK.unpack_bases_plain(packed))
          and int(buf[-1]) == 7, "unpack_bases into a (4m + 1)-byte "
          "buffer differs at m=%d" % m)
    return list(UNPACK_TAILS) + [m]


def back_to_back_ms(fn, sets: int, runs: int = 48) -> float:
    """Device time a launch over `runs` launches of fn(i) in a row, i
    taking `sets` buffer sets in turn (sized past the L2, so that each
    launch reads memory), with the stream kept busy while the host
    enqueues them: a launch's time without the fixed cost that a single
    event-timed launch carries."""
    import torch

    for i in range(sets):
        fn(i)
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(runs):
        fn(i % sets)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def stream_readings(name: str, unit: str, make, kern, plain, n: int,
                    moved) -> dict:
    """What holds a streaming kernel at its timed shape of n units, beside
    its single-launch time there: the same time at 16 units (the fixed cost
    of one event-timed launch) and at 32 Mi units (the streaming rate, the
    fixed cost spread thin), as by-shape results; the time a launch back to
    back over 8 buffer sets; and one launch after a flush that leaves no
    dirty line in the L2 (cuda_ms(clean=True)). make(size, seed) gives a
    call's arguments, kern(*args) and plain(*args) compute, moved(size) is
    the bytes the function must move."""
    res = {"by_shape": {}}
    for size, what in ((16, "one event-timed launch's fixed cost"),
                       (32 << 20, "the streaming rate")):
        args = make(size, 0)
        res["by_shape"]["%d %s (%s)" % (size, unit, what)] = held_and_timed(
            name, lambda: kern(*args), lambda: plain(*args), args,
            "%d %s" % (size, unit), plain_runs=3, moved=moved(size))
        del args
    sets = [make(n, seed) for seed in range(8)]
    res["back_to_back_ms"] = back_to_back_ms(lambda i: kern(*sets[i]), 8)
    res["clean_flush_ms"] = cuda_ms(lambda: kern(*sets[0]), clean=True)
    bound = 1e3 * moved(n) / HBM_BYTES_PER_S
    log("kernel %s back to back at %d %s, 48 launches over 8 buffer sets: "
        "%.4f ms a launch (bound %.4f ms, %.0f%%)"
        % (name, n, unit, res["back_to_back_ms"], bound,
           100 * bound / res["back_to_back_ms"]))
    log("kernel %s at %d %s after a clean flush: %.4f ms (%.0f%% of bound)"
        % (name, n, unit, res["clean_flush_ms"],
           100 * bound / res["clean_flush_ms"]))
    return res


# the edge cases of the streaming frontend kernels (pack_bases and
# encode_frontend_bytes), each placed by the kernel's own built wave: every
# byte value at every position of a 16-byte group, n around 64, one wave's
# bases and one either side, a view one byte off 16-byte alignment,
# 2^24 + 5 bases and the PE chunk
FRONT_CASES = ("every_byte", "n63", "n64", "n65", "wave-1", "wave",
               "wave+1", "misaligned", "2^24+5", "pe_chunk")


def front_case(name: str, wave: int):
    """numpy (seq, qual, bins, major) of a FRONT_CASES case, and the
    offset at which the kernel's view of seq and qual starts. Bases are
    half 'ACGTN' and half any byte; quals any byte; a palette of 63 chars
    (the most) besides the major 'F'."""
    import numpy as np

    rng = np.random.default_rng(1500 + FRONT_CASES.index(name))
    n, offset = {"n63": 63, "n64": 64, "n65": 65, "wave-1": wave - 1,
                 "wave": wave, "wave+1": wave + 1, "misaligned": 3 * 4096 + 7,
                 "2^24+5": (1 << 24) + 5, "pe_chunk": PE_BASES,
                 "every_byte": 256 * 16}[name], int(name == "misaligned")
    size = n + offset
    seq = rng.integers(0, 256, size=size, dtype=np.uint8)
    acgtn = rng.random(size) < 0.5
    seq[acgtn] = rng.choice(np.frombuffer(b"ACGTN", np.uint8),
                            size=int(acgtn.sum()))
    qual = rng.integers(0, 256, size=size, dtype=np.uint8)
    if name == "every_byte":
        # group g, position p: byte g + 37p (seq), 3g + 101p + 7 (qual)
        g, p = np.divmod(np.arange(size), 16)
        seq = ((g + 37 * p) % 256).astype(np.uint8)
        qual = ((3 * g + 101 * p + 7) % 256).astype(np.uint8)
    major = ord("F")
    bins = rng.choice(np.setdiff1d(np.arange(256), [major]), size=63,
                      replace=False).astype(np.uint8)
    return seq, qual, bins, major, offset


def front_edge_cases(dev) -> int:
    """pack_bases and encode_frontend_bytes exact against their plain
    versions on every FRONT_CASES case, one launch each, the byte form's
    outputs bool and int32; returns the cases run."""
    import torch

    from repaq_tpu_torch.ops import kernels as TK

    waves = dict(zip(("pack_bases", "encode_frontend_bytes"),
                     TK.frontend_waves()))
    runs = 0
    for name in FRONT_CASES:
        for kernel, wave in waves.items():
            seq, qual, bins, major, off = front_case(name, wave)
            seq_t = torch.from_numpy(seq).to(dev)[off:]
            args = ((seq_t,) if kernel == "pack_bases" else
                    (seq_t, torch.from_numpy(qual).to(dev)[off:],
                     torch.from_numpy(bins).to(dev), major))
            before = TK.launches[kernel]
            got = getattr(TK, kernel)(*args)
            want = getattr(TK, kernel + "_plain")(*args)
            torch.cuda.synchronize()
            if not isinstance(got, tuple):
                got, want = (got,), (want,)
            check(TK.launches[kernel] == before + 1
                  and max_abs_err(got, want) == 0
                  and [t.dtype for t in got] == [t.dtype for t in want],
                  "%s differs from its plain version on FRONT_CASES %s (n=%d)"
                  % (kernel, name, seq_t.shape[0]))
            runs += 1
    return runs


def fsm_inputs(dev, n: int, dtype, seed: int):
    """Seeded token-FSM inputs of the decode's quality stream: lengths
    {1, 1, 2, 4} and 0.1% forced restarts."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    lens = rng.choice(np.array([1, 1, 2, 4], np.uint8), size=n)
    return (torch.from_numpy(lens).to(dev).to(dtype),
            torch.from_numpy(rng.random(n) < 0.001).to(dev))


def kernel_phase(dev) -> dict:
    import numpy as np
    import torch

    from repaq_tpu_torch.ops import kernels as TK

    rng = np.random.default_rng(1262)
    n = B_READS * READ_LEN
    seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n)
    nmask = rng.random(n) < 0.001
    seq[nmask] = ord("N")
    qual = rng.choice(np.frombuffer(NOVA_QUALS, np.uint8), size=n, p=NOVA_P)
    qual[nmask] = ord("#")
    seq_t = torch.from_numpy(seq).to(dev)
    qual_t = torch.from_numpy(qual).to(dev)
    bins = torch.tensor(list(b"#,:"), dtype=torch.uint8, device=dev)
    major = ord("F")
    packed = torch.from_numpy(
        rng.integers(0, 256, size=n // 4, dtype=np.uint8)).to(dev)
    lens8, force = fsm_inputs(dev, n, torch.uint8, 175)
    lens32 = lens8.to(torch.int32)
    # the PE chunk: elided seq (G past the stored bases) and full qual
    pe_seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=PE_BASES)
    pe_seq[rng.random(PE_BASES) < 0.001] = ord("N")
    pe_seq[PE_BASES - PE_BASES // 6:] = ord("G")
    pe_qual = rng.choice(np.frombuffer(NOVA_QUALS, np.uint8), size=PE_BASES,
                         p=NOVA_P)
    pe_seq_t = torch.from_numpy(pe_seq).to(dev)
    pe_qual_t = torch.from_numpy(pe_qual).to(dev)
    # pack-only: 12 Mbase with a ragged tail
    pk_seq = torch.from_numpy(
        rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=12_000_003)).to(dev)

    se_shape = "seq+qual %d bases, 0.1%% N, NovaSeq quals" % n
    pe_shape = "PE chunk of %d bases, 0.1%% N, NovaSeq quals" % PE_BASES
    fsm_shape = ("%d token bytes, lengths {1,1,2,4}, 0.1%% forced restarts"
                 % n)
    results = {
        "encode_frontend": held_and_timed(
            "encode_frontend",
            lambda: TK.encode_frontend(seq_t, qual_t, bins, major),
            lambda: TK.encode_frontend_plain(seq_t, qual_t, bins, major),
            (seq_t, qual_t, bins), se_shape),
        "encode_frontend_bytes": held_and_timed(
            "encode_frontend_bytes",
            lambda: TK.encode_frontend_bytes(pe_seq_t, pe_qual_t, bins,
                                             major),
            lambda: TK.encode_frontend_bytes_plain(pe_seq_t, pe_qual_t, bins,
                                                   major),
            (pe_seq_t, pe_qual_t, bins), pe_shape),
        "pack_bases": held_and_timed(
            "pack_bases", lambda: TK.pack_bases(pk_seq),
            lambda: TK.pack_bases_plain(pk_seq), (pk_seq,),
            "%d bases" % pk_seq.shape[0]),
        "unpack_bases": held_and_timed(
            "unpack_bases", lambda: TK.unpack_bases(packed),
            lambda: TK.unpack_bases_plain(packed), (packed,),
            "%d packed bytes" % (n // 4)),
        "token_start_mask": held_and_timed(
            "token_start_mask", lambda: TK.token_start_mask(lens8, force),
            lambda: TK.token_start_mask_plain(lens8, force), (lens8, force),
            fsm_shape + ", uint8 lengths"),
    }
    # what the frontend costs the PE path, and the FSM with int32 lengths
    results["encode_frontend"]["by_shape"] = {
        se_shape: dict(results["encode_frontend"]),
        pe_shape: held_and_timed(
            "encode_frontend",
            lambda: TK.encode_frontend(pe_seq_t, pe_qual_t, bins, major),
            lambda: TK.encode_frontend_plain(pe_seq_t, pe_qual_t, bins,
                                             major),
            (pe_seq_t, pe_qual_t, bins), pe_shape)}
    # the streaming kernels: fixed cost, streaming rate, back to back and
    # after a clean flush, beside the single launch at the timed shape
    def rand_u8(size, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randint(0, 256, (size,), dtype=torch.uint8, device=dev,
                             generator=g)

    def frontend_args(size, seed):
        return (rand_u8(size, 2 * seed), rand_u8(size, 2 * seed + 1), bins,
                major)

    streaming = [
        ("unpack_bases", "packed bytes", n // 4,
         lambda size, seed: (rand_u8(size, seed),
                             torch.empty(4 * size, dtype=torch.uint8,
                                         device=dev)),
         lambda p, out: TK.unpack_bases(p, out=out),
         lambda p, out: TK.unpack_bases_plain(p), lambda m: 5 * m),
        ("pack_bases", "bases", pk_seq.shape[0],
         lambda size, seed: (rand_u8(size, seed),), TK.pack_bases,
         TK.pack_bases_plain, lambda m: m + (m + 3) // 4),
        ("encode_frontend_bytes", "bases", PE_BASES, frontend_args,
         TK.encode_frontend_bytes, TK.encode_frontend_bytes_plain,
         lambda m: 7 * m + (m + 3) // 4),
    ]
    for name, unit, size, make, kern, plain, moved in streaming:
        res = results[name]
        more = stream_readings(name, unit, make, kern, plain, size, moved)
        res["by_shape"] = {"%d %s" % (size, unit): dict(res),
                           **more.pop("by_shape")}
        res.update(more)
    log("kernel unpack_bases exact at m = %s (every tail; the last one into "
        "the decode's buffer)" % unpack_cases(dev, packed))
    log("kernels pack_bases and encode_frontend_bytes exact on %d edge cases "
        "(FRONT_CASES: every byte value at every position of a 16-byte "
        "group, n = 63, 64, 65, one wave's bases and one either side, a view "
        "one byte off alignment, 2^24 + 5 and the PE chunk), one launch "
        "each; waves %s bases" % (front_edge_cases(dev), TK.frontend_waves()))
    traced = TK.captured_ops(lambda: TK.encode_frontend_bytes(
        pe_seq_t, pe_qual_t, bins, major))
    check(len(traced) == 1 and "frontend_bytes_kernel" in traced[0],
          "encode_frontend_bytes is not one kernel a call: its capture "
          "holds %s" % traced)
    log("kernel encode_frontend_bytes: one call at the PE chunk captures "
        "as one kernel, %s" % traced[0])
    results["token_start_mask"]["by_shape"] = {
        fsm_shape + ", uint8 lengths": dict(results["token_start_mask"]),
        fsm_shape + ", int32 lengths": held_and_timed(
            "token_start_mask", lambda: TK.token_start_mask(lens32, force),
            lambda: TK.token_start_mask_plain(lens32, force),
            (lens32, force), fsm_shape + ", int32 lengths")}
    log("kernel token_start_mask exact on %d edge cases (n = 1, tile - 1, "
        "tile, tile + 1, 3000 tiles + 5; forced restarts at tile starts, "
        "all 4-byte tokens, tokens across tile edges, lengths outside "
        "1..4; uint8 and int32 lengths), one launch each"
        % fsm_edge_cases(dev))
    log("kernel encode_frontend exact at n = %s (n %% 4 = 1, 2, 3, 'N' and "
        "the major qual in the tail)" % frontend_ragged_cases(dev))
    # the run-boundary kernels at a whole chunk's bases (the ceiling) and
    # run_offsets at the coordinates' two rows of a 12-Mbase SE chunk's
    # 80,000 reads
    for name, shape, label in (
            ("run_offsets", (n,), "%d elements, a whole chunk's bases" % n),
            ("run_offsets", (2, 80_000), "(2, 80000) coordinate rows"),
            ("seg_positions", (n,), "%d elements, a whole chunk's bases"
             % n)):
        res = boundary_kernels_at(dev, name, shape, label, sum(shape))
        results.setdefault(name, dict(res, by_shape={}))["by_shape"][
            label] = res
    log("kernels run_offsets and seg_positions exact on %d edge cases (n = "
        "1, tile - 1, tile, tile + 1, 3 tiles + 5, 3000 tiles + 5; "
        "run_offsets 1-D and 2 rows: random, sparse and dense masks, all "
        "set, none, runs of 31-33 at step, warp and tile edges, a run of 3 "
        "tiles; seg_positions: starts random, first only, everywhere, "
        "nowhere, at warp and tile edges; unaligned starts; an empty input, "
        "no launch), one launch each; tiles %s" % (boundary_edge_cases(dev),
                                                   TK.run_tiles()))
    return results


def fsm_at_size(dev, n: int) -> dict:
    """The token FSM timed at n bytes (uint8 lengths, as the decode passes
    them), beside its bound."""
    from repaq_tpu_torch.ops import kernels as TK

    import torch

    lens, force = fsm_inputs(dev, n, torch.uint8, n)
    return held_and_timed(
        "token_start_mask", lambda: TK.token_start_mask(lens, force),
        lambda: TK.token_start_mask_plain(lens, force), (lens, force),
        "%d token bytes, uint8 lengths" % n, plain_runs=3)


def rans_shape_data():
    """(order, data, lanes) of each of RANS_SHAPES: NovaSeq qualities for
    order-1, a skewed alphabet for order-0, from seed 330."""
    import numpy as np

    rng = np.random.default_rng(330)
    for order, n, lanes in RANS_SHAPES:
        if order:
            data = rng.choice(np.frombuffer(NOVA_QUALS, np.uint8), size=n,
                              p=NOVA_P)
        else:
            data = rng.choice(np.frombuffer(b"ACGTACGTN\x00\xff", np.uint8),
                              size=n)
        yield order, data, lanes


def uniform_bytes(n: int, seed: int = 331):
    import numpy as np

    return np.random.default_rng(seed).integers(0, 256, size=n,
                                                dtype=np.uint8)


def rans_label(order: int, n: int, lanes: int, what: str) -> str:
    return "order-%d %d B in %d lanes%s" % (order, n, lanes, what)


def _rans_case_makers(window: int) -> dict:
    """name -> (order, n, lanes, shift, kind) of rans_case; kind is
    "quals", "uniform" or "one symbol"."""
    cases = {}
    for order in (0, 1):
        for what, length in (("window - 1", window - 1), ("window", window),
                             ("window + 1", window + 1),
                             ("2 window + 1", 2 * window + 1)):
            for extra in (0, 17):
                cases["o%d lanes of %s%s" % (
                    order, what, ", 17 one longer" if extra else "")] = (
                    order, 37 * length + extra, 37, 0, "quals")
        cases["o%d 1003 lanes" % order] = (order, 1003 * 9 + 501, 1003, 0,
                                          "quals")
        cases["o%d n < lanes" % order] = (order, 20, 64, 0, "quals")
        cases["o%d one lane" % order] = (order, 2 * window + 3, 1, 0,
                                        "quals")
        cases["o%d data 5 B past a boundary" % order] = (
            order, 70 * window + 11, 70, 5, "quals")
        cases["o%d one symbol" % order] = (order, 64 * (window + 3), 64, 0,
                                          "one symbol")
    cases["o1 uniform random bytes"] = (1, 2048 * 700, 2048, 0, "uniform")
    return cases


# the names do not depend on the window
RANS_CASES = sorted(_rans_case_makers(512))


def rans_case(name: str, window: int):
    """(order, data, lanes, shift) of one staging edge of rans_encode,
    whose lanes stage `window` steps at once: lanes not a multiple of any
    block size, n < lanes (empty lanes) and one lane, lane lengths of
    window - 1, window, window + 1 and 2 window + 1 (equal and ragged
    splits, so lanes start at odd offsets), a data pointer `shift` bytes
    past a 16-byte boundary, a one-symbol section (freq 4096), and order-1
    on uniform random bytes with all 65,536 contexts live."""
    import zlib

    import numpy as np

    order, n, lanes, shift, kind = _rans_case_makers(window)[name]
    seed = zlib.crc32(name.encode())
    if kind == "uniform":
        data = uniform_bytes(n, seed)
    elif kind == "one symbol":
        data = np.full(n, 0x42, np.uint8)
    else:
        data = np.random.default_rng(seed).choice(
            np.frombuffer(NOVA_QUALS, np.uint8), size=n, p=NOVA_P)
    return order, data, lanes, shift


def rans_case_inputs(dev, order, data, lanes, shift):
    """The tensors rans_encode takes for a case: data on `dev` starting
    `shift` bytes into its allocation, and the section's tables."""
    import numpy as np
    import torch

    from repaq_tpu_torch.ops import rans_device as RD

    _head, freqs, cum = RD.section_prologue(data, order, min(lanes,
                                                             len(data)))
    base = torch.zeros(shift + len(data), dtype=torch.uint8, device=dev)
    base[shift:] = torch.from_numpy(data).to(dev)
    f, c = (torch.from_numpy(a.astype(np.int32)).to(dev) for a in (freqs,
                                                                   cum))
    return base[shift:], f, c


def rans_edge_cases(dev) -> int:
    """rans_encode exact against its plain version on every case of
    RANS_CASES, and its section bytes equal to the host coder's; the
    count."""
    import torch

    from repaq_tpu_torch.codec import rans_np
    from repaq_tpu_torch.ops import rans_device as RD

    for label in RANS_CASES:
        order, data, lanes, shift = rans_case(label, RD.encode_window())
        d, f, c = rans_case_inputs(dev, order, data, lanes, shift)
        got = RD.rans_encode_device(d, f, c, lanes, order)
        want = RD.rans_encode_plain(d, f, c, lanes, order)
        torch.cuda.synchronize()
        check(max_abs_err(got, want) == 0, "rans_encode differs from its "
              "plain version on %s" % label)
        check(RD.encode_section_device(data, order, lanes, device=dev)
              == rans_np.encode_section(data, order=order, lanes=lanes),
              "rANS section bytes differ from the host coder's on %s"
              % label)
    return len(RANS_CASES)


def _decode_case_makers(window: int, shared_rows: int) -> dict:
    """name -> (order, n, lanes, shift, kind) of decode_case; kind is one of
    rans_case's, "sparse" or "symbols K" (K distinct bytes, none 0)."""
    cases = {}
    for order in (0, 1):
        for what, length in (("window - 1", window - 1), ("window", window),
                             ("window + 1", window + 1),
                             ("2 window + 1", 2 * window + 1)):
            for extra in (0, 17):
                cases["o%d lanes of %s%s" % (
                    order, what, ", 17 one longer" if extra else "")] = (
                    order, 37 * length + extra, 37, 0, "quals")
        cases["o%d 1003 lanes" % order] = (order, 1003 * 9 + 501, 1003, 0,
                                          "quals")
        cases["o%d n < lanes" % order] = (order, 20, 64, 0, "quals")
        cases["o%d one lane" % order] = (order, 2 * window + 3, 1, 0,
                                        "quals")
        cases["o%d payload 5 B past a boundary" % order] = (
            order, 70 * window + 11, 70, 5, "quals")
        cases["o%d one symbol" % order] = (order, 64 * (window + 3), 64, 0,
                                          "one symbol")
        cases["o%d lanes with no renormalisation word" % order] = (
            order, 64 * 40, 64, 0, "sparse")
    cases["o1 live contexts at the shared limit"] = (
        1, 64 * 300, 64, 0, "symbols %d" % (shared_rows - 1))
    cases["o1 live contexts one past the shared limit"] = (
        1, 64 * 300, 64, 0, "symbols %d" % shared_rows)
    cases["o1 uniform random bytes"] = (1, 2048 * 700, 2048, 0, "uniform")
    return cases


# the names do not depend on the window or the shared limit
DECODE_CASES = sorted(_decode_case_makers(124, 12))


def decode_case(name: str, window: int, shared_rows: int):
    """(order, data, lanes, shift) of one edge of rans_decode, whose lanes
    decode `window` steps between copy-outs and whose order-1 tables stay
    in shared memory up to `shared_rows` live contexts: lane lengths of
    window - 1, window, window + 1 and 2 window + 1 (equal and ragged), 1003
    lanes, n < lanes (the section takes n lanes of one byte), one lane, a
    payload `shift` bytes past a 16-byte boundary (lanes start at odd
    aligned offsets), a one-symbol section (freq 4096: no lane reads a
    word), lanes of 40 bytes that are mostly one symbol (some read no
    word), order-1 with shared_rows and shared_rows + 1 live contexts
    (context 0 and K other bytes), and order-1 on uniform random bytes
    with all 65,536 contexts live."""
    import zlib

    import numpy as np

    order, n, lanes, shift, kind = _decode_case_makers(window,
                                                       shared_rows)[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    quals = np.frombuffer(NOVA_QUALS, np.uint8)
    if kind == "uniform":
        data = uniform_bytes(n, zlib.crc32(name.encode()))
    elif kind == "one symbol":
        data = np.full(n, 0x42, np.uint8)
    elif kind == "sparse":
        data = rng.choice(quals[:2], size=n, p=[0.9, 0.1])
    elif kind.startswith("symbols "):
        k = int(kind.split()[1])
        data = rng.choice(np.arange(1, k + 1, dtype=np.uint8) * 7, size=n)
    else:
        data = rng.choice(quals, size=n, p=NOVA_P)
    return order, data, lanes, shift


def decode_case_inputs(dev, order, data, lanes, shift):
    """(rans_decode_device's arguments, offsets) for the host coder's
    section of `data`, its payload starting `shift` bytes into an
    allocation on `dev`."""
    import numpy as np
    import torch

    from repaq_tpu_torch.codec import rans_np
    from repaq_tpu_torch.ops import rans_device as RD

    enc = rans_np.encode_section(data, order=order, lanes=lanes)
    order, n, lanes, payload, counts, freqs, cum, sym, _ = RD.parse_section(
        enc)
    base = torch.zeros(shift + payload.shape[0], dtype=torch.uint8,
                       device=dev)
    base[shift:] = torch.from_numpy(payload.copy()).to(dev)
    args = (base[shift:], *(torch.from_numpy(a).to(dev) for a in (
        counts, sym, freqs.astype(np.int32), cum.astype(np.int32))),
        lanes, 0, order)
    return args, rans_np.lane_slices(n, lanes)


def decode_edge_cases(dev) -> dict:
    """rans_decode exact against its plain version (and the data) on every
    case of DECODE_CASES, placed by the built window and shared limit, one
    launch each; the routes taken, {route: cases}."""
    import numpy as np
    import torch

    from repaq_tpu_torch.ops import kernels as TK
    from repaq_tpu_torch.ops import rans_device as RD

    routes = {"shared": 0, "global": 0}
    for label in DECODE_CASES:
        order, data, lanes, shift = decode_case(label, RD.decode_window(),
                                                RD.decode_shared_rows())
        args, off = decode_case_inputs(dev, order, data, lanes, shift)
        before = TK.launches["rans_decode"]
        got = RD.rans_decode_device(*args, offsets=off)
        torch.cuda.synchronize()
        check(TK.launches["rans_decode"] == before + 1,
              "rans_decode launched %d times on %s"
              % (TK.launches["rans_decode"] - before, label))
        check(np.array_equal(got.cpu().numpy(), data)
              and torch.equal(got, RD.rans_decode_plain(*args, offsets=off)),
              "rans_decode differs from its plain version on %s" % label)
        routes[RD.last_decode[2]] += 1
    return routes


def _layout_case_makers(tile_steps: int, tile_lanes: int) -> dict:
    """name -> (steps, lanes, emits, starts, cap) of layout_case: emits is
    "mixed" (each lane its own emit rate in [0, 1)), "some lanes none",
    "none" or "all"; starts "back to back", "odd" or "gapped"; cap "full",
    "words" (through a lane's words) or "final" (through a final
    state)."""
    t, w = tile_steps, tile_lanes
    cases = {}
    for what, lanes in (("W - 1", w - 1), ("W", w), ("W + 1", w + 1),
                        ("W + 16", w + 16), ("1003", 1003), ("one", 1)):
        cases["lanes %s" % what] = (2 * t + 1, lanes, "mixed",
                                    "back to back", "full")
    for what, steps in (("T - 1", t - 1), ("T", t), ("T + 1", t + 1),
                        ("2 T + 1", 2 * t + 1)):
        cases["steps %s" % what] = (steps, 2 * w, "mixed", "back to back",
                                    "full")
    cases["no steps"] = (0, w + 1, "mixed", "back to back", "full")
    cases["lanes with no emits"] = (t + 1, w + 1, "some lanes none",
                                    "back to back", "full")
    cases["a one-symbol section (no emits)"] = (t + 1, 2 * w, "none",
                                                "back to back", "full")
    cases["every step emits"] = (2 * t + 1, 2 * w, "all", "back to back",
                                 "full")
    for lanes, what in ((2 * w, ""), (w + 1, ", lanes W + 1")):
        cases["odd starts" + what] = (t + 1, lanes, "mixed", "odd", "full")
        cases["gapped starts" + what] = (2 * t + 1, lanes, "mixed",
                                         "gapped", "full")
    for starts in ("back to back", "odd", "gapped"):
        cases["%s starts, cap through a lane's words" % starts] = (
            t + 1, 2 * w, "mixed", starts, "words")
        cases["%s starts, cap through a final state" % starts] = (
            t + 1, 2 * w, "mixed", starts, "final")
    return cases


# the names do not depend on the tile
LAYOUT_CASES = sorted(_layout_case_makers(256, 64))


def layout_case(name: str, tile):
    """(words, emits, final, start, out_cap) numpy inputs of rans_layout
    for one edge of its tiles ((steps, lanes) of the built kernel): lanes
    W - 1 .. W + 16 (whole and partial lane groups, with and without
    16-byte rows), 1003 and 1; steps T - 1 .. 2 T + 1 and none; lanes that
    never emit, no lane that emits, every step emitting; starts back to
    back (even, as the section coder makes them), odd, or gapped and not
    ascending; and an out_cap that cuts through a lane's words or through
    a final state."""
    import zlib

    import numpy as np

    steps, lanes, kind, starts, cap = _layout_case_makers(*tile)[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    words = rng.integers(0, 1 << 16, size=(steps, lanes), dtype=np.uint16)
    rate = {"mixed": rng.random(lanes), "none": np.zeros(lanes),
            "all": np.ones(lanes),
            "some lanes none": rng.random(lanes) * (np.arange(lanes) % 3 > 0),
            }[kind]
    emits = rng.random((steps, lanes)) < rate
    final = rng.integers(1 << 16, 1 << 32, size=lanes, dtype=np.int64)
    size = 4 + 2 * emits.sum(0)
    start = np.cumsum(size) - size
    if starts == "odd":
        start += 1
    elif starts == "gapped":
        gaps = rng.integers(0, 6, size=lanes)
        order = rng.permutation(lanes)
        placed = np.cumsum(size[order] + gaps) - size[order] + 3
        start[order] = placed
    cut = start[lanes // 2]
    out_cap = {"full": int((start + size).max()) + 5, "words": int(cut) + 7,
               "final": int(cut) + 2}[cap]
    return words, emits, final, start, out_cap


def layout_edge_cases(dev) -> int:
    """rans_layout exact against its plain version on every case of
    LAYOUT_CASES, placed by the built tile, one launch each; the count."""
    import torch

    from repaq_tpu_torch.ops import kernels as TK
    from repaq_tpu_torch.ops import rans_device as RD

    for label in LAYOUT_CASES:
        *arrays, cap = layout_case(label, RD.layout_tile())
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        before = TK.launches["rans_layout"]
        got = RD.rans_layout(*args, cap)
        torch.cuda.synchronize()
        check(TK.launches["rans_layout"] == before + 1,
              "rans_layout launched %d times on %s"
              % (TK.launches["rans_layout"] - before, label))
        check(torch.equal(got, RD.rans_layout_plain(*args, cap)),
              "rans_layout differs from its plain version on %s" % label)
    return len(LAYOUT_CASES)


def rans_kernel_phase(dev) -> dict:
    """The rANS kernels against their plain versions at RANS_SHAPES; the
    section they make must also be the host coder's. rans_encode also on
    an order-1 section of uniform random bytes and on its staging edges.
    Per kernel: the largest error over the shapes and the times at the
    first shape."""
    import numpy as np
    import torch

    from repaq_tpu_torch.codec import rans_np
    from repaq_tpu_torch.ops import rans_device as RD

    results = {}
    for order, data, lanes in rans_shape_data():
        n = data.shape[0]
        check(RD.encode_section_device(data, order, lanes, device=dev)
              == rans_np.encode_section(data, order=order, lanes=lanes),
              "rANS order-%d section of %d bytes differs from the host "
              "coder's" % (order, n))
        head, freqs, cum = RD.section_prologue(data, order, lanes)
        sym = RD._parse_tables(memoryview(head), 7, order)[2]
        d, f, c, sy = (torch.from_numpy(a).to(dev) for a in (
            data, freqs.astype(np.int32), cum.astype(np.int32), sym))
        off = rans_np.lane_slices(n, lanes)
        cap = 2 * n + 4 * lanes + 8
        payload, lane_bytes, total = RD.rans_encode_payload_device(
            d, f, c, lanes, order, cap)
        # the layout kernel is timed alone, on the encoder's outputs
        enc = RD.rans_encode_device(d, f, c, lanes, order)
        start = torch.cumsum(lane_bytes, 0) - lane_bytes
        dec = (payload[:int(total)], lane_bytes, sy, f, c, lanes, 0, order)
        # the live contexts counted on the host, as decode_section_device
        # counts them
        live = RD.live_contexts(freqs)
        out = RD._rans_decode(*dec, off, live)
        check(np.array_equal(out.cpu().numpy(), data),
              "rans_decode did not give the order-%d section back" % order)
        # bytes each function must move: its inputs once, its outputs once
        # (the layout writes the payload's `total` bytes)
        cases = {
            "rans_encode": (
                lambda: RD.rans_encode_device(d, f, c, lanes, order),
                lambda: RD.rans_encode_plain(d, f, c, lanes, order),
                nbytes(d, f, c) + nbytes(enc)),
            "rans_layout": (lambda: RD.rans_layout(*enc, start, cap),
                            lambda: RD.rans_layout_plain(*enc, start, cap),
                            nbytes(enc, start) + int(total)),
            "rans_decode": (
                lambda: RD._rans_decode(*dec, off, live),
                lambda: RD.rans_decode_plain(*dec, offsets=off),
                nbytes(*dec[:5]) + n),
        }
        shape = rans_label(order, n, lanes, "")
        for name, (kern, plain, moved) in cases.items():
            res = held_and_timed(name, kern, plain, (), shape, plain_runs=3,
                                 moved=moved)
            r = results.setdefault(name, dict(res, by_shape={}))
            r["max_abs_err"] = max(r["max_abs_err"], res["max_abs_err"])
            r["by_shape"][shape] = res
        # the layout's time includes the wrapper's zero fill of out_cap
        fill = results["rans_layout"]["by_shape"][shape]["fill_ms"] = cuda_ms(
            lambda: torch.zeros(cap, dtype=torch.uint8, device=dev))
        log("rans_layout at %s: the zero fill of out_cap = %d B alone %.4f "
            "ms" % (shape, cap, fill))
        # the decode's time includes the wrapper's table packing
        by = results["rans_decode"]["by_shape"][shape]
        by["live"], by["route"] = RD.last_decode[1:]
        by["table_ms"] = cuda_ms(lambda: RD.decode_table(
            sy, f, c, order, live if by["route"] == "shared" else None))
        log("rans_decode at %s: %d live contexts, %s route; the table "
            "packing (decode_table) alone %.4f ms"
            % (shape, by["live"], by["route"], by["table_ms"]))
    order, n, lanes = RANS_SHAPES[0]
    rans_encode_at(dev, results["rans_encode"], uniform_bytes(n), lanes,
                   ", uniform random bytes")
    log("kernel rans_encode exact on %d staging edge cases (window %d: lane "
        "lengths window - 1 .. 2 window + 1, equal and ragged; 1003 lanes; "
        "n < lanes; one lane; data 5 B past a 16-byte boundary; one symbol; "
        "order-1 with all 65,536 contexts live), section bytes equal to the "
        "host coder's" % (rans_edge_cases(dev), RD.encode_window()))
    routes = decode_edge_cases(dev)
    results["rans_decode"].update(window=RD.decode_window(),
                                  shared_rows=RD.decode_shared_rows(),
                                  edge_routes=routes)
    log("kernel rans_decode exact on %d edge cases (window %d, shared "
        "table up to %d live contexts: lane lengths window - 1 .. 2 window "
        "+ 1, equal and ragged; 1003 lanes; n < lanes; one lane; payload 5 "
        "B past a 16-byte boundary; one symbol; lanes with no "
        "renormalisation word; the shared limit and one past it; all "
        "65,536 contexts live), one launch each; routes %s"
        % (len(DECODE_CASES), RD.decode_window(), RD.decode_shared_rows(),
           routes))
    results["rans_layout"]["tile"] = list(RD.layout_tile())
    log("kernel rans_layout exact on %d tile edge cases (tile %d steps x %d "
        "lanes: lanes W - 1 .. W + 16, 1003, 1; steps T - 1 .. 2 T + 1, 0; "
        "lanes with no emits; no emits; every step emitting; odd and gapped "
        "starts; out_cap through a lane's words and through a final state), "
        "one launch each" % ((layout_edge_cases(dev),) + RD.layout_tile()))
    return results


def rans_encode_at(dev, res: dict, data, lanes: int, what: str) -> None:
    """rans_encode on an order-1 section, held against its plain version
    and timed, added to its by-shape readings."""
    import numpy as np
    import torch

    from repaq_tpu_torch.ops import rans_device as RD

    d, f, c = rans_case_inputs(dev, 1, np.asarray(data), lanes, 0)
    enc = RD.rans_encode_device(d, f, c, lanes, 1)
    shape = rans_label(1, d.shape[0], lanes, what)
    r = held_and_timed("rans_encode",
                       lambda: RD.rans_encode_device(d, f, c, lanes, 1),
                       lambda: RD.rans_encode_plain(d, f, c, lanes, 1), (),
                       shape, plain_runs=3, moved=nbytes(d, f, c) +
                       nbytes(enc))
    torch.cuda.synchronize()
    res["max_abs_err"] = max(res["max_abs_err"], r["max_abs_err"])
    res["by_shape"][shape] = r


def rans_sweep_phase(dev, res: dict, dres: dict, real=None) -> None:
    """tools/profile_rans.py's sweep of rans_encode's block size, window
    and batch at RANS_SHAPES and the uniform order-1 section (and the
    real one when given), each build exact against the package's; then the
    chain floor of every shape in res's by-shape readings, and of the
    decode's step (shared table) at RANS_SHAPES in dres's."""
    import tempfile

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import profile_rans as PR

    with tempfile.TemporaryDirectory() as tmp:
        cases = PR.shape_cases(dev, real)
        t0 = time.perf_counter()
        swept = PR.sweep(dev, cases, tmp)
        for name, times in swept.items():
            log("rans_encode sweep, %s: %s" % (name, "; ".join(
                "%s %s" % (label, "refused" if ms is None else "%.4f ms" % ms)
                for label, ms in times.items())))
        best = {label: min((ms, name) for name, t in swept.items()
                           for lab, ms in t.items()
                           if lab == label and ms is not None)
                for label in cases}
        log("rans_encode sweep: %d builds in %.1f s; fastest %s"
            % (len(swept), time.perf_counter() - t0, "; ".join(
                "%s %s (%.4f ms)" % (label, name, ms)
                for label, (ms, name) in best.items())))
        probe = PR.probe_lib(tmp)
        cycles = PR.chain_cycles(dev, probe)
        dcycles = PR.decode_chain_cycles(dev, probe)
    mhz = PR.max_sm_clock_mhz()
    for label, inp in cases.items():
        floor = PR.chain_floor_ms(inp["steps"], cycles, mhz)
        r = res["by_shape"].get(label)
        if r is not None:
            r["chain_floor_ms"] = floor
        log("rans_encode chain floor at %s: %d steps x %.2f cycles at %.0f "
            "MHz = %.4f ms%s" % (label, inp["steps"], cycles, mhz, floor,
                                 "" if r is None else "; the kernel %.4f ms "
                                 "(%.0f%% of the floor's rate)"
                                 % (r["ms"], 100 * floor / r["ms"])))
    res["chain_cycles"] = cycles
    res["max_sm_mhz"] = mhz
    order, n, lanes = RANS_SHAPES[0]
    res["chain_floor_ms"] = res["by_shape"][rans_label(order, n, lanes,
                                                       "")]["chain_floor_ms"]
    dres.update(chain_cycles=dcycles, max_sm_mhz=mhz)
    for order, n, lanes in RANS_SHAPES:
        r = dres["by_shape"][rans_label(order, n, lanes, "")]
        steps = -(-n // lanes)
        r["chain_floor_ms"] = PR.chain_floor_ms(steps, dcycles["shared"],
                                                mhz)
        log("rans_decode chain floor at %s: %d steps x %.2f cycles (table "
            "in shared memory; %.2f read from global memory) at %.0f MHz = "
            "%.4f ms; the wrapper %.4f ms (%.0f%% of the floor's rate)"
            % (rans_label(order, n, lanes, ""), steps, dcycles["shared"],
               dcycles["global"], mhz, r["chain_floor_ms"], r["ms"],
               100 * r["chain_floor_ms"] / r["ms"]))
    dres["chain_floor_ms"] = dres["by_shape"][rans_label(
        *RANS_SHAPES[0], "")]["chain_floor_ms"]


def boundary_kernels_at_main_path_sizes(kres: dict, cres: dict) -> None:
    """run_offsets and seg_positions at the shapes the SE and PE corpora
    handed them (phases 4 and 5), added to their by-shape readings; the SE
    quality stream's reading becomes run_offsets' headline, the SE decode
    tokens' seg_positions'."""
    import torch

    for tag in ("se", "pe"):
        for (name, what), shape in cres[tag]["boundary_shapes"].items():
            label = "%s %s %s" % (tag.upper(), what, shape)
            res = boundary_kernels_at(torch.device("cuda:0"), name, shape,
                                      label, sum(shape))
            kres[name]["by_shape"][label] = res
            if tag == "se" and what in ("quality stream", "decode tokens"):
                kres[name].update(res)


# ---------------------------------------------------------------------------
# phase 3: goldens through the CLI
# ---------------------------------------------------------------------------


def run_all(cmds, env) -> None:
    """Run the commands concurrently; every one must exit 0."""
    procs = [subprocess.Popen(c, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for c in cmds]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for c, p, (_o, err) in zip(cmds, procs, outs):
        check(p.returncode == 0, "%s exited %d:\n%s"
              % (" ".join(c), p.returncode, err.decode(errors="replace")))


def golden_phase() -> None:
    fx = os.path.join(ROOT, "tests", "fixtures")
    gdir = os.path.join(WORK, "goldens")
    os.makedirs(gdir, exist_ok=True)
    env = dict(os.environ, REPAQ_DEVICE_MIN_BASES="0", PYTHONPATH=ROOT)
    cli = [sys.executable, "-m", "repaq_tpu_torch.cli"]

    def unzip(base):
        fq = os.path.join(gdir, base + ".fq")
        with gzip.open(os.path.join(fx, base + ".fq.gz")) as src, \
                open(fq, "wb") as dst:
            shutil.copyfileobj(src, dst)
        return fq

    # (inputs, golden, compress args, decompress args, decoded outputs)
    cases = []
    for base, golden, extra in SE_GOLDENS:
        fq = unzip(base)
        rfq, back = fq[:-3] + ".rfq", fq[:-3] + ".back.fq"
        cases.append(([fq], golden, ["-i", fq, "-o", rfq, *extra],
                      ["-i", rfq, "-o", back], [back], rfq))
    for r1, r2, golden, extra in PE_GOLDENS:
        f1, f2 = unzip(r1), unzip(r2)
        rfq = os.path.join(gdir, golden[:-4] + ".rfq")
        b1, b2 = f1[:-3] + ".back.fq", f2[:-3] + ".back.fq"
        cases.append(([f1, f2], golden,
                      ["-i", f1, "-I", f2, "-o", rfq, *extra],
                      ["-i", rfq, "-o", b1, "-O", b2], [b1, b2], rfq))
    run_all([cli + ["-c", "--engine", "device", *c[2]] for c in cases], env)
    run_all([cli + ["-d", "--engine", "device", *c[3]] for c in cases], env)
    for inputs, golden, _c, _d, backs, rfq in cases:
        with open(rfq, "rb") as f, open(os.path.join(fx, golden), "rb") as g:
            check(f.read() == g.read(), "%s: bytes differ from the golden"
                  % golden)
        for fq, back in zip(inputs, backs):
            with open(fq, "rb") as f, open(back, "rb") as g:
                # the reference's decoder writes LF line ends for CRLF input
                check(f.read().replace(b"\r\n", b"\n") == g.read(),
                      "%s: decode differs from the input" % fq)
    log("goldens: %d SE and %d PE fixtures byte-identical to the reference "
        "encoder and round-tripped through python -m repaq_tpu_torch.cli "
        "--engine device" % (len(SE_GOLDENS), len(PE_GOLDENS)))


# ---------------------------------------------------------------------------
# phases 4 and 5: the ~96-Mbase corpora, single-end and paired-end
# ---------------------------------------------------------------------------

# TruSeq adapters, each continued with seeded bases to a read's length:
# what a read holds past the end of a short insert
ADAPTER1 = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCAC"
ADAPTER2 = b"AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"


def illumina_heads(rng, reads: int, mate: int) -> list:
    """Illumina name lines: tiles of 4000 reads, y ascending in a tile."""
    import numpy as np

    tile = 1101 + np.arange(reads) // 4000
    x = rng.integers(1000, 32000, size=reads)
    y = 1000 + np.cumsum(rng.integers(0, 8, size=reads)) % 30000
    return [b"@A00251:85:HVWJYDSXY:1:%d:%d:%d %d:N:0:ATCACGTT\n"
            % (t, xi, yi, mate) for t, xi, yi in zip(tile, x, y)]


def write_fastq(path: str, heads: list, seq, qual) -> int:
    parts = []
    for h, s, q in zip(heads, seq, qual):
        parts += (h, s.tobytes(), b"\n+\n", q.tobytes(), b"\n")
    data = b"".join(parts)
    with open(path, "wb") as f:
        f.write(data)
    return len(data)


def nova_quals(rng, seq):
    """NovaSeq 4-bin qualities for seq, 0.1% of its bases made 'N' with
    qual '#'."""
    import numpy as np

    nmask = rng.random(seq.shape) < 0.001
    seq[nmask] = ord("N")
    qual = rng.choice(np.frombuffer(NOVA_QUALS, np.uint8), size=seq.shape,
                      p=NOVA_P)
    qual[nmask] = ord("#")
    return qual


def make_corpus(paths: list, reads: int, read_len: int, seed: int) -> int:
    """A seeded single-end NovaSeq-like FASTQ; returns its size in
    bytes."""
    import numpy as np

    rng = np.random.default_rng(seed)
    seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(reads, read_len))
    qual = nova_quals(rng, seq)
    return write_fastq(paths[0], illumina_heads(rng, reads, 1), seq, qual)


def make_pe_corpus(paths: list, pairs: int, read_len: int, seed: int) -> int:
    """Seeded R1/R2 FASTQs of pairs read from both ends of a fragment.
    Inserts are drawn from 120-400 bp for 95% of the pairs, so mates of an
    insert of at most 2L - 12 overlap forward, and from 30-100 bp for the
    rest, so the mates run into the adapters and overlap backward by the
    insert's length (a stored backward overlap needs |ov| <= 103 under the
    header's overlap shift of -24). Returns the two files' size in
    bytes."""
    import numpy as np

    rng = np.random.default_rng(seed)
    r1, r2 = pe_reads(rng, pairs, read_len)
    size = 0
    heads = illumina_heads(rng, pairs, 1)
    for path, mate, seq in ((paths[0], 1, r1), (paths[1], 2, r2)):
        qual = nova_quals(rng, seq)
        size += write_fastq(path, [h.replace(b" 1:N:", b" %d:N:" % mate)
                                   for h in heads], seq, qual)
    return size


def pe_reads(rng, pairs: int, read_len: int):
    """The (pairs, read_len) u8 R1 and R2 reads of make_pe_corpus, drawn
    from rng."""
    import numpy as np

    acgt = np.frombuffer(b"ACGT", np.uint8)
    comp = np.zeros(256, dtype=np.uint8)
    comp[np.frombuffer(b"ACGT", np.uint8)] = np.frombuffer(b"TGCA", np.uint8)
    short = rng.random(pairs) < 0.05
    insert = np.where(short, rng.integers(30, 101, size=pairs),
                      rng.integers(120, 401, size=pairs))
    frag = rng.choice(acgt, size=(pairs, 400))
    ad = [np.concatenate([np.frombuffer(a, np.uint8),
                          rng.choice(acgt, size=read_len)])[:read_len]
          for a in (ADAPTER1, ADAPTER2)]
    j = np.arange(read_len)[None, :]
    ins = insert[:, None]
    rows = np.arange(pairs)[:, None]
    past = np.clip(j - ins, 0, read_len - 1)
    r1 = np.where(j < ins, frag[rows, np.minimum(j, 399)], ad[0][past])
    r2 = np.where(j < ins, comp[frag[rows, np.clip(ins - 1 - j, 0, 399)]],
                  ad[1][past])
    return r1.astype(np.uint8), r2.astype(np.uint8)


def read_chunks(rfq: str):
    """(header, chunks) of an .rfq file."""
    from repaq_tpu_torch.format.chunk import RfqChunk
    from repaq_tpu_torch.format.header import RfqHeader

    chunks = []
    with open(rfq, "rb") as f:
        header = RfqHeader.read(f)
        while True:
            chunk = RfqChunk.read(f, header)
            if not chunk.reads:
                return header, chunks
            chunks.append(chunk)


def qual_buffer_sizes(header, chunks) -> list:
    """Per chunk, the quality buffer the device decode runs the token FSM
    over, as the engine sizes it."""
    from repaq_tpu_torch.codec.device_engine import DeviceEngine

    return [DeviceEngine.decode_caps(header, c)[0] for c in chunks]


BOUNDARY_KERNELS = ("run_offsets", "seg_positions")


@contextlib.contextmanager
def recorded_boundary_shapes(shapes: list):
    """Within the block, the run_offsets and seg_positions wrappers append
    (name, shape) of each call to `shapes` and then run as they are."""
    from repaq_tpu_torch.ops import kernels as TK

    saved = {name: getattr(TK, name) for name in BOUNDARY_KERNELS}

    def recording(name):
        def kernel(x, *rest):
            shapes.append((name, tuple(x.shape)))
            return saved[name](x, *rest)
        return kernel

    for name in BOUNDARY_KERNELS:
        setattr(TK, name, recording(name))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(TK, name, fn)


def main_path_boundary_shapes(shapes: list, cut: int) -> dict:
    """The run-boundary kernels' shapes in one round trip whose first `cut`
    calls were the compress's, {(kernel, what): shape}: run_offsets' quality
    stream (its largest 1-D call) and coordinate rows (its 2-D one), and
    seg_positions' decode tokens (its largest call)."""
    enc, dec = shapes[:cut], shapes[cut:]
    pick = {("run_offsets", "quality stream"):
            [s for _n, s in enc if len(s) == 1],
            ("run_offsets", "coordinate rows"):
            [s for _n, s in enc if len(s) == 2],
            ("seg_positions", "decode tokens"):
            [s for n, s in dec if n == "seg_positions"]}
    return {k: max(v, key=lambda s: (s[-1], s)) for k, v in pick.items()
            if v}


# launches a chunk of the kernels whose count a chunk fixes, by direction:
# the smoke corpora's chunks all code N positions, qualities and
# coordinates, and no quality escapes
def per_chunk(what: str, pe: bool) -> dict:
    """The launches a chunk of the kernels whose count a chunk fixes, on
    compress or decompress: run_offsets 3 an encode, seg_positions 1 a
    decode, pe_encode_pairs 1 a PE encode and pe_decode_rows 1 a PE decode
    (none in the other direction, none on SE), overlap_pairs none; fill_runs
    3 an encode (the quality, N-position and coordinate
    streams' bytes) and 2 a decode (the N positions' deltas, the N bases);
    fill_sorted_runs 1 a decode (the quality runs), concat_row_spans 1 a
    PE encode (the elision); bucket_compact 5 an encode (the grouping by
    bin, the quality and N streams' multi-byte tokens, the N flags, the
    coordinates' multi-byte values) and 1 a decode (the quality tokens)."""
    enc = what == "compress"
    return {"run_offsets": 3 * enc, "seg_positions": int(not enc),
            "overlap_pairs": 0, "pe_encode_pairs": int(enc and pe),
            "pe_decode_rows": int(pe and not enc),
            "fill_runs": 3 if enc else 2,
            "fill_sorted_runs": int(not enc),
            "concat_row_spans": int(enc and pe),
            "bucket_compact": 5 if enc else 1}


def check_chunk_launches(where: str, what: str, launches: dict,
                         chunks: int, pe: bool) -> None:
    for name, per in per_chunk(what, pe).items():
        check(launches.get(name, 0) == per * chunks, "%s %s: %s launched %d "
              "times for %d chunks, %d a chunk expected"
              % (where, what, name, launches.get(name, 0), chunks, per))


def corpus_phase(device: str, pe: bool, reads: int = 640_000,
                 read_len: int = 150, chunk_kb: int = 12_000) -> dict:
    """One corpus through repaq_tpu_torch.cli.main twice; the launch
    counts of the first run (the main path's) and the rates of both."""
    import numpy as np

    from repaq_tpu_torch import cli, pipeline
    from repaq_tpu_torch.codec.device_engine import DeviceEngine
    from repaq_tpu_torch.ops import kernels as TK

    tag = "pe" if pe else "se"
    os.makedirs(WORK, exist_ok=True)
    mates = (1, 2) if pe else (1,)
    fqs = [os.path.join(WORK, "%s%d.fq" % (tag, m)) for m in mates]
    backs = [os.path.join(WORK, "%s%d.back.fq" % (tag, m)) for m in mates]
    out = os.path.join(WORK, tag + ".rfq")
    t0 = time.perf_counter()
    if pe:
        size = make_pe_corpus(fqs, reads // 2, read_len, seed=97)
    else:
        size = make_corpus(fqs, reads, read_len, seed=96)
    log("corpus %s: %d reads x %d bp in %d file(s), %d FASTQ bytes, made in "
        "%.1f s" % (tag, reads, read_len, len(fqs), size,
                    time.perf_counter() - t0))

    eng = DeviceEngine(device)
    ins = ["-i", fqs[0]] + (["-I", fqs[1]] if pe else [])
    outs = ["-o", backs[0]] + (["-O", backs[1]] if pe else [])

    def roundtrip(seen=None):
        t0 = time.perf_counter()
        rc = cli.main(["-c", *ins, "-o", out, "-k", str(chunk_kb),
                       "--engine", "device"], engine=eng.config())
        enc_s = time.perf_counter() - t0
        check(rc == 0, "port compress exited %d" % rc)
        if seen is not None:
            seen["compress"] = (dict(TK.launches), len(seen["shapes"]))
        t0 = time.perf_counter()
        rc = cli.main(["-d", "-i", out, *outs, "--engine", "device"],
                      engine=eng.config())
        check(rc == 0, "port decompress exited %d" % rc)
        return enc_s, time.perf_counter() - t0

    seen = {"shapes": []}
    TK.reset_launches()
    with recorded_boundary_shapes(seen["shapes"]):
        # the first run in this process: torch's lazy setup
        cold = roundtrip(seen)
    launches = dict(TK.launches)
    stats = dict(eng.stats)
    warm = roundtrip()

    host_out = os.path.join(WORK, tag + ".host.rfq")
    workers = max(1, min(8, os.cpu_count() or 1))
    t0 = time.perf_counter()
    if pe:
        pipeline.compress_pe(fqs[0], fqs[1], host_out,
                             chunk_size=chunk_kb * 1000,
                             engine=pipeline.get_engine("vectorized"),
                             workers=workers)
    else:
        pipeline.compress_se(fqs[0], host_out, chunk_size=chunk_kb * 1000,
                             engine=pipeline.get_engine("vectorized"),
                             workers=workers)
    host_s = time.perf_counter() - t0
    with open(out, "rb") as f, open(host_out, "rb") as g:
        check(f.read() == g.read(),
              "%s: port output differs from the host engine's" % tag)
    for fq, back in zip(fqs, backs):
        with open(fq, "rb") as f, open(back, "rb") as g:
            check(f.read() == g.read(),
                  "%s: port decode differs from the input" % fq)

    header, chunks = read_chunks(out)
    st = stats
    log("corpus %s: %d chunks; engine stats %s; kernel launches %s"
        % (tag, len(chunks), st, launches))
    check(st["device_chunks"] == len(chunks) == st["device_decodes"],
          "%s: not every chunk took the device path: %s" % (tag, st))
    check(st["host_chunks"] == 0 and st["host_decodes"] == 0,
          "%s: host routes taken: %s" % (tag, st))
    for name, _src, _rep, paths in KERNELS:
        if tag in paths:
            check(launches[name] > 0, "kernel %s never launched on the %s "
                  "path" % (name, tag))
    enc, cut = seen["compress"]
    dec = {k: launches[k] - enc[k] for k in launches}
    for what, counts in (("compress", enc), ("decompress", dec)):
        check_chunk_launches(tag, what, counts, len(chunks), pe)
    counted = per_chunk("compress", pe)
    log("corpus %s: run-boundary, overlap, fill and compaction launches, "
        "compress %s, decompress %s, for %d chunks"
        % (tag, {k: enc[k] for k in counted}, {k: dec[k] for k in counted},
           len(chunks)))
    res = {"launches": launches, "bytes": size, "cold": cold, "warm": warm,
           "host_enc_s": host_s, "chunks": len(chunks), "fqs": fqs,
           "rfq": out, "chunk_kb": chunk_kb,
           "qual_bufs": qual_buffer_sizes(header, chunks),
           "boundary_shapes": main_path_boundary_shapes(seen["shapes"], cut)}
    log("corpus %s: run-boundary kernels' shapes on the main path: %s"
        % (tag, res["boundary_shapes"]))
    log("corpus %s: quality buffers of the token FSM on decode: %s bytes"
        % (tag, res["qual_bufs"]))
    if pe:
        check(header.encode_pe_by_overlap(), "pe: no overlap elision")
        ov = np.concatenate([np.frombuffer(c.overlap_buf, np.int8)
                             for c in chunks]).astype(np.int64)
        ov -= header.overlap_shift
        res["fwd"], res["bwd"] = float((ov > 0).mean()), float((ov < 0).mean())
        log("corpus pe: %d pairs, %.2f%% stored with a forward overlap, "
            "%.2f%% with a backward one" % (ov.shape[0], 100 * res["fwd"],
                                            100 * res["bwd"]))
        check(res["fwd"] >= 0.01 and res["bwd"] >= 0.01,
              "pe: forward or backward overlap share below 1%")
    return res


# ---------------------------------------------------------------------------
# phase 7: the multi-GPU mesh (--mesh_devices)
# ---------------------------------------------------------------------------


def mesh_phase(tag: str, corpus: dict) -> dict:
    """A corpus of phase 4 or 5 through the mesh entries on two engines
    sharing cuda:0 (the main path, launch counts from 0) and, when torch
    sees more cards, on every card; then through the CLI with
    --mesh_devices -1. Every run's bytes must equal the serial run's
    (phase 4 or 5), the decode must give the inputs back, and every engine
    must have coded and decoded chunks on the device."""
    import torch

    from repaq_tpu_torch import cli
    from repaq_tpu_torch.codec.device_engine import DeviceEngine
    from repaq_tpu_torch.ops import kernels as TK
    from repaq_tpu_torch.parallel import mesh_engine as M

    pe = tag == "pe"
    fqs = corpus["fqs"]
    with open(corpus["rfq"], "rb") as f:
        serial = f.read()
    out = os.path.join(WORK, tag + ".mesh.rfq")
    backs = [os.path.join(WORK, "%s%d.mesh.fq" % (tag, m))
             for m in range(1, len(fqs) + 1)]
    workers = max(1, min(8, os.cpu_count() or 1))

    def same_as_input(what: str) -> None:
        for fq, back in zip(fqs, backs):
            with open(fq, "rb") as f, open(back, "rb") as g:
                check(f.read() == g.read(), "%s %s: decode differs from the "
                      "input" % (tag, what))

    sets = [["cuda:0"] * 2]
    if torch.cuda.device_count() > 1:
        sets.append(M.cuda_devices())
    res = {"runs": []}
    for i, devices in enumerate(sets):
        what = "on %s" % ", ".join(devices)
        if i == 0:
            TK.reset_launches()
        t0 = time.perf_counter()
        if pe:
            enc = M.compress_pe_mesh(fqs[0], fqs[1], out,
                                     chunk_size=12_000_000, devices=devices,
                                     workers=workers)
        else:
            enc = M.compress_se_mesh(fqs[0], out, chunk_size=12_000_000,
                                     devices=devices, workers=workers)
        enc_s = time.perf_counter() - t0
        if i == 0:
            enc_launches = dict(TK.launches)
        t0 = time.perf_counter()
        dec = M.decompress_se_mesh(out, backs[0], devices=devices,
                                   out2=backs[1] if pe else "",
                                   workers=workers)
        dec_s = time.perf_counter() - t0
        if i == 0:
            res["launches"] = dict(TK.launches)
            check_chunk_launches("mesh " + tag, "compress", enc_launches,
                                 corpus["chunks"], pe)
            check_chunk_launches(
                "mesh " + tag, "decompress",
                {k: v - enc_launches[k] for k, v in TK.launches.items()},
                corpus["chunks"], pe)
        with open(out, "rb") as f:
            check(f.read() == serial, "%s %s: mesh bytes differ from the "
                  "serial run's" % (tag, what))
        same_as_input(what)
        for stats, key in ((enc, "device_chunks"), (dec, "device_decodes")):
            check(all(s[key] > 0 for s in stats["engines"]), "%s %s: an "
                  "engine has no %s: %s" % (tag, what, key, stats))
        check(all(s["host_chunks"] == 0 for s in enc["engines"]), "%s %s: "
              "an engine took a chunk to the host: %s" % (tag, what, enc))
        res["runs"].append((devices, enc_s, dec_s))
        log("mesh %s %s: bytes equal to the serial run's, inputs back; "
            "encode %.3f s, decode %.3f s; engines %s, then %s"
            % (tag, what, enc_s, dec_s, enc["engines"], dec["engines"]))
    for name, _src, _rep, paths in KERNELS:
        if "mesh_" + tag in paths:
            check(res["launches"][name] > 0, "kernel %s never launched on "
                  "the mesh %s path" % (name, tag))
    log("mesh %s: kernel launches on two engines sharing cuda:0: %s"
        % (tag, {k: v for k, v in res["launches"].items() if v}))

    # the CLI: -1 is every card torch sees; one card runs the serial
    # pipeline on the engine given, as the JAX CLI does
    made = []
    make = M.make_engine
    M.make_engine = lambda d: made.append(make(d)) or made[-1]
    one = DeviceEngine("cuda:0")
    ins = ["-i", fqs[0]] + (["-I", fqs[1]] if pe else [])
    outs = ["-o", backs[0]] + (["-O", backs[1]] if pe else [])
    try:
        for argv in (["-c", *ins, "-o", out, "-k", "12000"],
                     ["-d", "-i", out, *outs]):
            rc = cli.main([*argv, "--mesh_devices", "-1", "--engine",
                           "device"], engine=one.config())
            check(rc == 0, "%s: %s --mesh_devices -1 exited %d"
                  % (tag, argv[0], rc))
    finally:
        M.make_engine = make
    with open(out, "rb") as f:
        check(f.read() == serial, "%s: the CLI's --mesh_devices -1 bytes "
              "differ from the serial run's" % tag)
    same_as_input("CLI --mesh_devices -1")
    engines = made or [one]
    for e in engines:
        check(e.stats["device_chunks"] + e.stats["device_decodes"] > 0,
              "%s CLI: an engine took no chunk: %s" % (tag, e.stats))
    log("mesh %s CLI --mesh_devices -1 (%d card(s) seen): bytes equal to the "
        "serial run's, inputs back; engines %s"
        % (tag, torch.cuda.device_count(), [e.stats for e in engines]))
    return res


# ---------------------------------------------------------------------------
# phase 6: .rfqz, the device rANS stage
# ---------------------------------------------------------------------------


def rfqz_phase(tag: str, fqs: list, fastq_bytes: int) -> dict:
    """A corpus of phase 4 or 5 to .rfqz through repaq_tpu_torch.cli.main
    with --engine device, twice: at the CLI's default 16,000-kb chunks
    (the main path, whose launch counts are reported; the engine's
    12-Mbase window sends every chunk to its host route) and with -k
    12000, where the engine's workers run chunks on cuda:0 while the main
    thread codes sections there. Each is held against the host coder's
    bytes at the same chunking. Then, outside the counted runs, every rANS
    section of the default-chunk file is decoded on the card against
    rans_np, and -d gives the inputs back."""
    from collections import Counter

    from repaq_tpu_torch import cli
    from repaq_tpu_torch.codec import rans_np
    from repaq_tpu_torch.format import rfqz
    from repaq_tpu_torch.codec.device_engine import DeviceEngine
    from repaq_tpu_torch.ops import kernels as TK
    from repaq_tpu_torch.ops import rans_device as RD

    ins = ["-i", fqs[0]] + (["-I", fqs[1]] if len(fqs) > 1 else [])
    backs = [os.path.join(WORK, "%s%d.rfqz.fq" % (tag, m))
             for m in range(1, len(fqs) + 1)]
    coder = RD.encode_section_device

    def compress(dst: str, engine=None, extra=()):
        """(wall s, the --profile stage lines) of one .rfqz compress: the
        engine's config under --engine device, else the host coder."""
        err = io.StringIO()
        name = "vectorized" if engine is None else "device"
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = cli.main(["-c", *ins, "-o", dst, *extra, "--engine", name,
                           "--profile"],
                          engine=None if engine is None else engine.config())
        wall = time.perf_counter() - t0
        check(rc == 0, "%s: .rfqz compress with --engine %s exited %d:\n%s"
              % (tag, name, rc, err.getvalue()))
        return wall, " ".join(" ".join(line.split()[1:3]) for line in
                              err.getvalue().splitlines()
                              if line.startswith("[profile]   "))

    def device_compress(dst: str, extra=()) -> dict:
        """One --engine device compress, launch counts from 0, with the
        sections the coder was given ((order, n, lanes) each) and the wall
        time inside it."""
        eng = DeviceEngine("cuda:0")
        census, coder_s = [], [0.0]
        largest_o1 = [None, 0]

        def counted(data, order=0, lanes=rans_np.DEFAULT_LANES, *, device):
            census.append((order, len(data), max(1, min(lanes, len(data)))))
            if order == 1 and (largest_o1[0] is None
                               or len(data) > len(largest_o1[0])):
                largest_o1[:] = [bytes(data), census[-1][2]]
            t0 = time.perf_counter()
            try:
                return coder(data, order, lanes, device=device)
            finally:
                coder_s[0] += time.perf_counter() - t0

        TK.reset_launches()
        RD.encode_section_device = counted
        try:
            wall, prof = compress(dst, eng, extra)
        finally:
            RD.encode_section_device = coder
        launches = dict(TK.launches)
        check(census, "%s: no section reached the device coder" % tag)
        check(launches["rans_encode"] == launches["rans_layout"]
              == len(census), "%s: %d sections reached the coder but "
              "rans_encode launched %d times"
              % (tag, len(census), launches["rans_encode"]))
        return {"wall": wall, "prof": prof, "census": census,
                "coder_s": coder_s[0], "launches": launches,
                "stats": dict(eng.stats), "largest_o1": largest_o1}

    runs = {}
    for label, extra in (("default", ()), ("k12000", ("-k", "12000"))):
        out = os.path.join(WORK, "%s.%s.rfqz" % (tag, label))
        host_out = os.path.join(WORK, "%s.%s.host.rfqz" % (tag, label))
        dev = device_compress(out, extra)
        dev["host_s"], dev["host_prof"] = compress(host_out, None, extra)
        with open(out, "rb") as f, open(host_out, "rb") as g:
            check(f.read() == g.read(), "%s: .rfqz bytes (%s chunks) differ "
                  "from the host coder's" % (tag, label))
        dev["out"] = out
        runs[label] = dev
    main, shared = runs["default"], runs["k12000"]
    check(shared["stats"]["device_chunks"] > 0
          and shared["launches"]["encode_frontend"] > 0,
          "%s: with -k 12000 no chunk took the device engine (%s)"
          % (tag, shared["stats"]))

    decoded = []
    routes = Counter()

    def decode_both(buf, off=0):
        want = rans_np.decode_section(buf, off)
        got = RD.decode_section_device(buf, off, device="cuda:0")
        check(got == want, "%s: device decode of the rANS section at %d "
              "differs from rans_np's" % (tag, off))
        decoded.append(len(want[0]))
        routes[RD.last_decode] += 1  # (order, live contexts, route)
        return got

    before = TK.launches["rans_decode"]
    reader = rfqz.RfqzReader(main["out"], decode_section=decode_both)
    rfq_bytes = len(reader.read())
    reader.close()
    check(decoded and TK.launches["rans_decode"] - before == len(decoded),
          "%s: %d sections decoded but rans_decode launched %d times"
          % (tag, len(decoded), TK.launches["rans_decode"] - before))
    log("rfqz %s: sections decoded on the card by (order, live contexts, "
        "route): %s" % (tag, "; ".join("%s x %d" % (k, v) for k, v in
                                       sorted(routes.items()))))
    dec = ["-o", backs[0]] + (["-O", backs[1]] if len(backs) > 1 else [])
    rc = cli.main(["-d", "-i", main["out"], *dec, "--engine", "device"])
    check(rc == 0, "%s: .rfqz decompress exited %d" % (tag, rc))
    for fq, back in zip(fqs, backs):
        with open(fq, "rb") as f, open(back, "rb") as g:
            check(f.read() == g.read(),
                  "%s: .rfqz decode differs from the input" % fq)

    census = main["census"]
    by = Counter(("o%d" % o, "ragged" if n % ln else "equal")
                 for o, n, ln in census)
    log("rfqz %s: %d sections through the device coder (%s), %d B of "
        "section input; largest %s; %d rANS sections decoded on the card "
        "after the run, equal to rans_np's; launches %s"
        % (tag, len(census), ", ".join("%s %s %d" % (k + (v,))
                                       for k, v in sorted(by.items())),
           sum(n for _o, n, _l in census),
           sorted(census, key=lambda c: -c[1])[:4], len(decoded),
           {k: v for k, v in main["launches"].items() if v}))
    log("rfqz %s: census (order, bytes, lanes): %s; engine stats %s"
        % (tag, census, main["stats"]))
    log("rfqz %s: %.3f s of the %.3f s device-coder compress inside the "
        "section coder (host prologue, copies, kernels); main-thread "
        "stages: %s; host-coder compress %.3f s: %s"
        % (tag, main["coder_s"], main["wall"], main["prof"],
           main["host_s"], main["host_prof"]))
    log("rfqz %s -k 12000: device engine and device coder on cuda:0 in one "
        "compress, bytes equal to the host coder's: engine stats %s, %d "
        "sections coded by rans_encode, launches %s; %.3f s (%.3f s in the "
        "coder), host-coder compress %.3f s"
        % (tag, shared["stats"], len(shared["census"]),
           {k: v for k, v in shared["launches"].items() if v},
           shared["wall"], shared["coder_s"], shared["host_s"]))
    return {"launches": main["launches"], "bytes": fastq_bytes,
            "size": os.path.getsize(main["out"]), "enc_s": main["wall"],
            "host_s": main["host_s"], "rfq_bytes": rfq_bytes,
            "sections": len(census), "coder_s": main["coder_s"],
            "largest_o1": main["largest_o1"]}


# ---------------------------------------------------------------------------
# phase 8: sharded (--num_shards, and the torch.distributed transport)
# ---------------------------------------------------------------------------

# one rank of the sharded CLI: argv[1] is its engine's device, the rest the
# CLI's arguments; prints the rank's wall, engine stats and kernel launches
SHARD_CLI_RANK = r"""
import json, sys, time
from repaq_tpu_torch import cli
from repaq_tpu_torch.codec.device_engine import DeviceEngine
from repaq_tpu_torch.ops import kernels as TK

eng = DeviceEngine(sys.argv[1])
TK.reset_launches()
t0 = time.perf_counter()
rc = cli.main(sys.argv[2:], engine=eng.config())
print(json.dumps({"rc": rc, "wall_s": time.perf_counter() - t0,
                  "stats": eng.stats, "launches": TK.launches}))
sys.exit(rc)
"""

# one rank of compress_distributed_torch, on a process group the rank makes
# itself: its engine's device, backend, rendezvous URL, world size, rank,
# in1, in2 ("" for SE), out1, chunk size in bases, codec workers; prints
# the rank's wall, timings, stats, launches
TRANSPORT_RANK = r"""
import datetime, json, sys, time
import torch.distributed as tdist
from repaq_tpu_torch.codec.device_engine import DeviceEngine
from repaq_tpu_torch.ops import kernels as TK
from repaq_tpu_torch.parallel import torchdist as T

dev, backend, url, nproc, pid, in1, in2, out1, k, workers = sys.argv[1:11]
eng = DeviceEngine(dev)
timings = {}
TK.reset_launches()
t0 = time.perf_counter()
tdist.init_process_group(backend, init_method=url, world_size=int(nproc),
                         rank=int(pid),
                         timeout=datetime.timedelta(seconds=300))
try:
    T.compress_distributed_torch(
        in1, out1, in2=in2, chunk_size=int(k), engine=eng.config(),
        is_pe=bool(in2), workers=int(workers), timings=timings)
finally:
    tdist.destroy_process_group()
print(json.dumps({"wall_s": time.perf_counter() - t0, "timings": timings,
                  "stats": eng.stats, "launches": TK.launches}))
"""

RANK_TIMEOUT_S = 300

# the kernels each direction of a shard must launch in every rank
SHARD_KERNELS = {"compress": ("encode_frontend", "run_offsets",
                              "bucket_compact", "fill_runs"),
                 "decompress": ("unpack_bases", "token_start_mask",
                                "seg_positions", "fill_runs",
                                "fill_sorted_runs", "bucket_compact")}


def rank_env(rank: int, per_card: bool) -> dict:
    """A rank process's environment: the checkout on the path, process
    groups over the loopback (one host), and with per_card the rank-th
    card the only one it sees."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if per_card:
        import torch

        seen = os.environ.get("CUDA_VISIBLE_DEVICES")
        ids = (seen.split(",") if seen else
               [str(i) for i in range(torch.cuda.device_count())])
        env["CUDA_VISIBLE_DEVICES"] = ids[rank]
    return env


def run_ranks(cmds, envs) -> tuple:
    """Every rank process started at once, each with its environment; all
    must exit 0 within RANK_TIMEOUT_S. Returns the wall from the first
    start to the last exit and the JSON of each rank's last output line."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, cwd=ROOT, env=e, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE)
             for c, e in zip(cmds, envs)]
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT_S) for p in procs]
    except subprocess.TimeoutExpired as e:
        raise SmokeFailure("a rank process ran past %d s: %s"
                           % (RANK_TIMEOUT_S, " ".join(e.cmd[3:]))) from e
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    ranks = []
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, "rank %d of %d exited %d:\n%s"
              % (r, len(procs), p.returncode,
                 err.decode(errors="replace")[-3000:]))
        ranks.append(json.loads(out.decode().strip().splitlines()[-1]))
    return wall, ranks


def shard_plan() -> tuple:
    """(the CLI's shard counts, whether each rank sees its own card, the
    transport's (backend, world size, one card a rank) runs) for the
    cards torch sees."""
    import torch

    cards = torch.cuda.device_count()
    if cards == 1:
        return [2], False, [("nccl", 1, False), ("gloo", 2, False)]
    return (sorted({2, min(cards, 4)}), True,
            [("nccl", 1, False), ("gloo", 2, False),
             ("nccl", min(cards, 4), True)])


def shard_phase(tag: str, corpus: dict, card: str) -> dict:
    """A corpus of phase 4 or 5 through the sharded CLI, compress then
    decompress, at 2 shards (the main path, whose summed launches are
    reported) and, with more cards, at one shard a card; then through
    compress_distributed_torch over NCCL and gloo. Bytes must equal the
    serial run's, the decode the inputs; every rank's chunks must take
    the device, and its kernels launch."""
    from repaq_tpu_torch.parallel.distributed import partition

    pe = tag == "pe"
    fqs, chunks = corpus["fqs"], corpus["chunks"]
    k = str(corpus["chunk_kb"])
    with open(corpus["rfq"], "rb") as f:
        serial = f.read()
    counts, per_card, runs = shard_plan()
    workers = max(1, min(8, os.cpu_count() or 1))
    out = os.path.join(WORK, tag + ".shard.rfq")
    backs = [os.path.join(WORK, "%s%d.shard.fq" % (tag, m))
             for m in range(1, len(fqs) + 1)]
    ins = ["-i", fqs[0]] + (["-I", fqs[1]] if pe else [])
    outs = ["-o", backs[0]] + (["-O", backs[1]] if pe else [])
    res = {"cli": [], "transport": []}

    for n in counts:
        where = ("one card a rank" if per_card
                 else "both ranks on cuda:0")
        envs = [rank_env(r, per_card) for r in range(n)]
        launches = {}
        walls = {}
        for what, argv, done, host in (
                ("compress", ["-c", *ins, "-o", out, "-k", k],
                 "device_chunks", "host_chunks"),
                ("decompress", ["-d", "-i", out, *outs],
                 "device_decodes", "host_decodes")):
            wall, ranks = run_ranks(
                [[sys.executable, "-c", SHARD_CLI_RANK, "cuda:0", *argv,
                  "--engine", "device", "--num_shards", str(n), "--shard",
                  str(r)] for r in range(n)], envs)
            for r, (rank, (lo, hi)) in enumerate(zip(ranks,
                                                     partition(chunks, n))):
                st = rank["stats"]
                check(st[done] == hi - lo and st[host] == 0,
                      "%s --num_shards %d %s: rank %d took %s of its %d "
                      "chunks to the device: %s"
                      % (tag, n, what, r, st[done], hi - lo, st))
                for name in SHARD_KERNELS[what]:
                    check(hi == lo or rank["launches"][name] > 0,
                          "%s --num_shards %d %s: kernel %s never launched "
                          "in rank %d" % (tag, n, what, name, r))
                check_chunk_launches(
                    "%s --num_shards %d rank %d" % (tag, n, r), what,
                    rank["launches"], hi - lo, pe)
                for name, count in rank["launches"].items():
                    launches[name] = launches.get(name, 0) + count
            walls[what] = (wall, [rank["wall_s"] for rank in ranks])
            log("shard %s CLI --num_shards %d %s (%s): %.3f s wall from the "
                "first rank's start to the last one's exit, ranks %s s "
                "inside cli.main, on %s; engine stats %s"
                % (tag, n, what, where, wall,
                   ["%.3f" % rank["wall_s"] for rank in ranks], card,
                   [rank["stats"] for rank in ranks]))
        with open(out, "rb") as f:
            check(f.read() == serial, "%s --num_shards %d: bytes differ "
                  "from the serial run's" % (tag, n))
        for fq, back in zip(fqs, backs):
            with open(fq, "rb") as f, open(back, "rb") as g:
                check(f.read() == g.read(), "%s --num_shards %d: decode "
                      "differs from the input" % (tag, n))
        log("shard %s CLI --num_shards %d: bytes equal to the serial run's, "
            "inputs back; kernel launches summed over the ranks %s"
            % (tag, n, {k_: v for k_, v in launches.items() if v}))
        if n == 2:
            res["launches"] = launches
        res["cli"].append((n, where, walls))

    tout = os.path.join(WORK, tag + ".torchdist.rfq")
    for backend, n, per_card in runs:
        rdv = os.path.join(WORK, "rendezvous.%s.%s.%d" % (tag, backend, n))
        if os.path.exists(rdv):
            os.remove(rdv)
        where = ("one card a rank" if per_card
                 else "every rank's engine on cuda:0")
        wall, ranks = run_ranks(
            [[sys.executable, "-c", TRANSPORT_RANK, "cuda:0", backend,
              "file://" + rdv, str(n), str(r), fqs[0],
              fqs[1] if pe else "", tout, str(int(k) * 1000), str(workers)]
             for r in range(n)], [rank_env(r, per_card) for r in range(n)])
        with open(tout, "rb") as f:
            check(f.read() == serial, "%s compress_distributed_torch over "
                  "%s at world size %d: bytes differ from the serial run's"
                  % (tag, backend, n))
        for r, rank in enumerate(ranks):
            check(rank["stats"]["host_chunks"] == 0
                  and rank["stats"]["device_chunks"] > 0,
                  "%s %s world size %d: rank %d's chunks did not all take "
                  "the device: %s" % (tag, backend, n, r, rank["stats"]))
            log("shard %s transport %s world size %d (%s), rank %d: %s; "
                "%.3f s inside the call; on %s"
                % (tag, backend, n, where, r,
                   json.dumps(rank["timings"], sort_keys=True),
                   rank["wall_s"], card))
        log("shard %s transport %s world size %d: bytes equal to the serial "
            "run's; %d slab rounds of %d-byte parts; %.3f s wall for the "
            "group, on %s" % (tag, backend, n, ranks[0]["timings"]["rounds"],
                              max(rk["timings"]["part_bytes"]
                                  for rk in ranks), wall, card))
        res["transport"].append((backend, n, where, wall,
                                 [rk["timings"] for rk in ranks]))
    return res


# ---------------------------------------------------------------------------


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "repaq_tpu_torch")):
        log("chip_smoke: no repaq_tpu_torch package beside this script")
        return 2
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: torch sees no CUDA device")
        return 2
    import numpy as np

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log("python %s, torch %s, CUDA %s, %s"
        % (sys.version.split()[0], torch.__version__, torch.version.cuda,
           kind))
    from repaq_tpu_torch.ops import _build
    from repaq_tpu_torch.ops import rans_device as RD

    try:
        build_native()
        t0 = time.perf_counter()
        _build.library()
        log("kernels: built from repaq_tpu_torch/csrc and loaded in %.1f s"
            % (time.perf_counter() - t0))
        kres = kernel_phase(torch.device("cuda:0"))
        kres["overlap_pairs"] = overlap_kernel_phase(torch.device("cuda:0"))
        kres.update(pair_kernel_phase(torch.device("cuda:0")))
        kres["fill_runs"] = fill_kernel_phase(torch.device("cuda:0"))
        kres.update(sorted_runs_phase(torch.device("cuda:0")))
        kres["bucket_compact"] = compact_kernel_phase(torch.device("cuda:0"))
        kres.update(rans_kernel_phase(torch.device("cuda:0")))
        golden_phase()
        cres = {"se": corpus_phase("cuda:0", pe=False),
                "pe": corpus_phase("cuda:0", pe=True)}
        median = int(statistics.median(cres["se"]["qual_bufs"]))
        kres["token_start_mask"]["by_shape"][
            "median SE quality buffer, %d token bytes, uint8 lengths"
            % median] = fsm_at_size(torch.device("cuda:0"), median)
        boundary_kernels_at_main_path_sizes(kres, cres)
        for tag in ("se", "pe"):
            cres["rfqz_" + tag] = rfqz_phase(tag, cres[tag]["fqs"],
                                             cres[tag]["bytes"])
        check(all(RD.decode_routes.values()), "rans_decode took one route "
              "only over phases 2 and 6: %s" % RD.decode_routes)
        kres["rans_decode"]["routes"] = dict(RD.decode_routes)
        log("rans_decode launches by route over phases 2 and 6: %s"
            % RD.decode_routes)
        # rans_encode on the SE compress's largest order-1 section, then
        # its shape sweep and chain floor
        data, lanes = cres["rfqz_se"]["largest_o1"]
        real = (np.frombuffer(data, np.uint8).copy(), lanes)
        rans_encode_at(torch.device("cuda:0"), kres["rans_encode"], *real,
                       ", real .rfq bytes")
        rans_sweep_phase(torch.device("cuda:0"), kres["rans_encode"],
                         kres["rans_decode"], real)
        log("mesh: torch sees %d CUDA device(s)%s"
            % (torch.cuda.device_count(),
               "; two engines share cuda:0, so this is a byte check, not a "
               "scaling figure" if torch.cuda.device_count() == 1 else ""))
        for tag in ("se", "pe"):
            cres["mesh_" + tag] = mesh_phase(tag, cres[tag])
        counts, per_card, runs = shard_plan()
        log("shard: torch sees %d CUDA device(s); the CLI runs --num_shards "
            "%s (%s); the transport runs %s"
            % (torch.cuda.device_count(), " and ".join(map(str, counts)),
               "one card a rank" if per_card else "both ranks on cuda:0",
               ", ".join("%s at world size %d%s"
                         % (b, n, " one card a rank" if pc else "")
                         for b, n, pc in runs)))
        for tag in ("se", "pe"):
            cres["shard_" + tag] = shard_phase(tag, cres[tag], card)
    except (SmokeFailure, RuntimeError) as e:
        log("chip_smoke: FAIL: %s" % e)
        return 1
    for tag in ("se", "pe"):
        res = cres[tag]
        mb = res["bytes"] / 1e6
        for label in ("cold", "warm"):
            enc_s, dec_s = res[label]
            log("corpus %s %s: encode %.1f MB/s (%.3f s), decode %.1f MB/s "
                "(%.3f s), FASTQ MB per wall second through "
                "repaq_tpu_torch.cli.main on %s"
                % (tag, label, mb / enc_s, enc_s, mb / dec_s, dec_s, card))
        log("corpus %s: host vectorized engine encode %.1f MB/s (%.3f s), "
            "same machine" % (tag, mb / res["host_enc_s"], res["host_enc_s"]))
        rz = cres["rfqz_" + tag]
        log("rfqz %s: %d B, %.4f%% of FASTQ; encode %.1f MB/s (%.3f s) with "
            "the device coder (--engine device), %.1f MB/s (%.3f s) with the "
            "host coder (--engine vectorized), FASTQ MB per wall second on %s"
            % (tag, rz["size"], 100 * rz["size"] / res["bytes"],
               mb / rz["enc_s"], rz["enc_s"], mb / rz["host_s"], rz["host_s"],
               card))
        for devices, enc_s, dec_s in cres["mesh_" + tag]["runs"]:
            log("mesh %s on %s: encode %.1f MB/s (%.3f s), decode %.1f MB/s "
                "(%.3f s), FASTQ MB per wall second through the mesh entries "
                "on %s" % (tag, ", ".join(devices), mb / enc_s, enc_s,
                           mb / dec_s, dec_s, card))
        for n, where, walls in cres["shard_" + tag]["cli"]:
            log("shard %s CLI --num_shards %d (%s): compress %.3f s, "
                "decompress %.3f s wall per file, rank processes' start "
                "included, on %s" % (tag, n, where, walls["compress"][0],
                                     walls["decompress"][0], card))
    shutil.rmtree(WORK, ignore_errors=True)

    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "paths": list(paths) or NO_PATH[name],
         "launches": sum(cres[t]["launches"][name] for t in paths),
         **kres[name]}
        for name, src, rep, paths in KERNELS
    ]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
