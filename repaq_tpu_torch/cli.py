"""Command-line interface of the PyTorch/CUDA port:
``python -m repaq_tpu_torch.cli``, flag-compatible with the reference tool
(reference main.cpp:29-49) and with ``repaq_tpu.cli`` for ``.rfq``,
``.rfq.xz`` and ``.rfqz`` files.

``--engine device`` binds the torch engine on ``cuda:0``. ``auto`` picks
that engine when CUDA is available and the host ``vectorized`` engine
otherwise. The device engine never runs on the CPU: without CUDA,
``--engine device`` exits non-zero. Under ``--engine device`` a ``.rfqz``
output's rANS sections are coded on ``cuda:0`` too (``ops/rans_device.py``);
``.rfqz`` input is read with the host decoder. ``--mesh_devices`` fans the
chunks over CUDA devices, one device engine each (parallel/mesh_engine.py),
and exits non-zero without CUDA. ``--num_shards N --shard i`` codes the
i-th of N contiguous chunk ranges to a part file, and shard 0 assembles the
parts in order (parallel/distributed.py); under ``--engine device`` every
shard runs its engine on ``cuda:0``, and a ``.rfqz`` part's sections take
the host coder, as in repaq_tpu.cli. With both flags the shard branch wins.

The ``.rfq.xz`` paths pipe through the external ``xz`` binary with the same
level/dict-size policy as the reference (main.cpp:134-177), but via an
in-process subprocess pipe instead of re-invoking the CLI through a shell.
"""

from __future__ import annotations

import argparse
import functools
import os
import subprocess
import sys

from . import pipeline
from .constants import VERSION_NUM
from .format.header import RfqFormatError
from .format.rfqz import RfqzReader, RfqzWriter

def is_fastq_file(name: str) -> bool:
    return name.endswith((".fq", ".fastq", ".fq.gz", ".fastq.gz"))


def is_rfq_file(name: str) -> bool:
    # .rfqz is this framework's native second entropy stage (interleaved
    # rANS, format/rfqz.py) — the in-process replacement for the
    # reference's external `xz` pipeline.
    return name.endswith((".rfq", ".rfq.xz", ".rfqz"))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="repaq-tpu",
        description="repack FASTQ to a smaller binary file (.rfq), on a CUDA GPU",
    )
    p.add_argument("--in1", "-i", default="", help="input file name")
    p.add_argument("--out1", "-o", default="", help="output file name")
    p.add_argument("--in2", "-I", default="", help="read2 input file name (PE)")
    p.add_argument("--out2", "-O", default="", help="read2 output file name (PE)")
    p.add_argument("--compress", "-c", action="store_true")
    p.add_argument("--decompress", "-d", action="store_true")
    p.add_argument(
        "--chunk", "-k", type=int, default=None,
        help="chunk size (kilo bases) for encoding, default 1000 "
        "(16000 for .rfqz output: bigger chunks give the entropy stage "
        "purer per-stream sections)",
    )
    p.add_argument("--stdin", action="store_true", help="input from STDIN")
    p.add_argument("--stdout", action="store_true", help="write to STDOUT")
    p.add_argument("--interleaved_in", action="store_true")
    p.add_argument("--verify", "-v", action="store_true")
    p.add_argument("--fast_verify", "-f", action="store_true")
    p.add_argument("--compare", "-p", action="store_true")
    p.add_argument("--rfq_to_compare", "-r", default="")
    p.add_argument("--json_compare_result", "-j", default="")
    p.add_argument("--thread", "-t", type=int, default=1)
    p.add_argument("--compression", "-z", type=int, default=3)
    p.add_argument(
        "--engine", default="auto",
        choices=["auto", "oracle", "vectorized", "device"],
        help="codec engine: 'device' runs the CUDA kernels on cuda:0 as "
        "the chunk codec (host route for ragged/tiny/oversized chunks); "
        "'auto' is 'device' when CUDA is available, else 'vectorized' "
        "(REPAQ_ENGINE overrides it)",
    )
    p.add_argument(
        "--workers", "-w", type=int, default=0,
        help="codec worker threads for compress AND decompress (chunks are "
        "data-parallel; output is identical for any worker count). "
        "0 (default) = auto: one worker per CPU, capped at 8; 1 forces "
        "the serial path. Extension over the reference.",
    )
    p.add_argument(
        "--profile", action="store_true",
        help="print per-stage wall-clock/throughput counters to stderr",
    )
    p.add_argument(
        "--num_shards", type=int, default=0,
        help="multi-host data-parallel compress OR decompress: total "
        "process count. Each process codes a contiguous chunk range to "
        "<out1>.part<shard>; shard 0 assembles the parts in order once "
        "all exist. Extension over the reference (compress: plain non-gz "
        "inputs, .rfq/.rfqz output; decompress: .rfq input, plain "
        "non-gz FASTQ output).",
    )
    p.add_argument(
        "--shard", type=int, default=0,
        help="this process's rank in [0, num_shards)",
    )
    p.add_argument(
        "--mesh_devices", type=int, default=0,
        help="chunks fanned across N local CUDA devices (-1: every device "
        "torch sees), one device engine each whatever --engine says; "
        "output identical to the serial run",
    )
    p.add_argument(
        "--no_assemble", action="store_true",
        help="with --num_shards: leave part files on disk (rank 0 does not "
        "concatenate); use when ranks run on different hosts",
    )
    p.add_argument("--version", action="version",
                   version="repaq-tpu %s" % VERSION_NUM.decode())
    return p


def _wait_for_parts(parts: list[str]) -> None:
    """Rank-0 shard assembly: wait for peer part files with failure
    detection. Besides the total deadline (REPAQ_SHARD_TIMEOUT, default
    3600 s), die once no NEW part appears for REPAQ_SHARD_STALL seconds
    (default 300): a crashed peer never writes its part, and a live one
    writes within the stall window."""
    import time as _time

    timeout = float(os.environ.get("REPAQ_SHARD_TIMEOUT", 3600))
    stall = float(os.environ.get("REPAQ_SHARD_STALL", 300))
    deadline = _time.time() + timeout
    seen = sum(os.path.exists(p) for p in parts)
    last_progress = _time.time()
    while not all(os.path.exists(p) for p in parts):
        now = _time.time()
        have = sum(os.path.exists(p) for p in parts)
        if have > seen:
            seen, last_progress = have, now
        missing = [p for p in parts if not os.path.exists(p)]
        if now > deadline:
            _die("timed out waiting for shard part files: %s"
                 % ", ".join(missing))
        if now - last_progress > stall:
            _die("no shard progress for %.0f s (peer crashed?); still "
                 "missing: %s" % (stall, ", ".join(missing)))
        _time.sleep(0.2)


def _xz_compress_args(compression: int, threads: int) -> list[str]:
    # reference main.cpp:138-154
    args = ["xz", "-z", "-c"]
    if threads > 1:
        args.append("-T%d" % threads)
    if compression <= 4:
        args.append("-%d" % (compression + 5))
    else:
        dict_size = (64 * 1024 * 1024) << (compression - 4)
        if compression == 9:
            dict_size = 1536 * 1024 * 1024
        args.append("--lzma2=dict=%d" % dict_size)
    if compression >= 4 and threads > 1:
        print(
            "WARNING: when repaq compression level is >= 4, only single "
            "thread will be used for xz. Your options: compression = %d, "
            "thread = %d" % (compression, threads),
            file=sys.stderr,
        )
    return args


def self_test() -> int:
    """Built-in self test (`repaq-tpu test`, reference main.cpp:20-24 /
    unittest.cpp). Runs the name-parser check the reference runs, plus
    coder roundtrips."""
    import numpy as np

    from .codec import kernels_np as K
    from .codec import oracle
    from .meta import parse_name

    m = parse_name(b"@A00251:28:H3YV7DSXX:40:1101:2356:1000 1:N:0:TAAGTGGC")
    assert m.name_part1 == b"@A00251:28:H3YV7DSXX"
    assert (m.lane, m.tile, m.x, m.y) == (40, 1101, 2356, 1000)
    assert m.name_part2 == b" 1:N:0:TAAGTGGC"
    print("FastqMeta test: PASSED")

    seq = b"ACGTNACGTACGTGGCCATTA"
    assert bytes(oracle.unpack_bases_2bit(oracle.pack_bases_2bit(seq), len(seq))) == (
        seq.replace(b"N", b"G")
    )
    print("2-bit pack test: PASSED")

    assert oracle.reverse_complement(b"ACGTN") == b"NACGT"
    print("reverse complement test: PASSED")

    qual = np.frombuffer(b"FF::F,FFF::F", dtype=np.uint8)
    enc = K.encode_positions(np.flatnonzero(qual == ord(":")))
    assert np.array_equal(
        K.decode_positions(enc), np.flatnonzero(qual == ord(":"))
    )
    print("position coder test: PASSED")

    vals = np.array([1000, 1000, 1032, 15000, 15000, 2000000], dtype=np.int64)
    assert np.array_equal(K.decode_coords(K.encode_coords(vals), 6), vals)
    print("coordinate coder test: PASSED")
    return 0


def get_engine(name: str = "auto") -> pipeline.EngineConfig:
    """pipeline.get_engine, with its refusal of 'device' without CUDA
    turned into the CLI's error exit."""
    try:
        return pipeline.get_engine(name)
    except RuntimeError as e:
        _die("--engine %s: %s" % (name, e))


def rfqz_section_coder(engine_name: str):
    """The section coder a .rfqz output uses: the port's device rANS on
    cuda:0 under --engine device, where the JAX CLI uses its own
    (repaq_tpu/cli.py:398-411), else None, the host coder."""
    if engine_name != "device":
        return None
    from .ops.rans_device import encode_section_device

    return functools.partial(encode_section_device, device="cuda:0")


def main(argv: list[str] | None = None,
         engine: pipeline.EngineConfig | None = None) -> int:
    """CLI entry. engine: run this EngineConfig instead of the one
    --engine names (a caller that reads the engine's stats afterwards)."""
    if argv is None:
        argv = sys.argv[1:]
    if len(argv) == 1 and argv[0] == "test":
        return self_test()
    args = build_parser().parse_args(argv)
    if args.workers < 1:
        args.workers = max(1, min(8, os.cpu_count() or 1))

    mode_count = sum([args.compress, args.decompress, args.compare])
    if mode_count > 1:
        print(
            "repaq can run in compress/decompress/compare mode, you can only "
            "choose any one mode.",
            file=sys.stderr,
        )
        return -1
    if args.decompress:
        mode = "decompress"
    elif args.compare:
        mode = "compare"
    else:
        mode = "compress"

    if args.chunk is not None:
        chunk_size = max(100, args.chunk) * 1000
    elif (mode == "compress" and args.out1.endswith(".rfqz")
          and not args.stdout):
        # the JAX CLI's .rfqz default; --stdout writes a plain .rfq stream
        chunk_size = 16_000_000
    else:
        chunk_size = 1_000_000
    threads = max(1, min(16, args.thread))
    compression = max(1, min(9, args.compression))

    in1, out1 = args.in1, args.out1
    if mode == "compress" and args.stdout and out1:
        print("Output to STDOUT, ignore --out1 = %s" % out1, file=sys.stderr)
        out1 = ""
    if mode == "decompress" and args.stdin and in1:
        print("Input from STDIN, ignore --in1 = %s" % in1, file=sys.stderr)
        in1 = ""
    rfq_compare = args.rfq_to_compare
    if mode == "compare" and args.stdin and rfq_compare:
        print(
            "Input from STDIN, ignore --rfq_to_compare = %s" % rfq_compare,
            file=sys.stderr,
        )
        rfq_compare = ""

    # ---- validation (reference options.cpp:36-111) ----
    if not in1:
        if args.in2:
            _die("read2 input is specified by <in2>, but read1 input is not specified by <in1>")
        if args.stdin:
            in1 = "/dev/stdin"
        else:
            _die("Please specify input file by <in1>, or enable --stdin if you want to read STDIN")
    elif not os.path.exists(in1):
        _die("Failed to open file: %s" % in1)
    if args.in2 and not os.path.exists(args.in2):
        _die("Failed to open file: %s" % args.in2)
    if not out1:
        if args.out2:
            _die("read2 output is specified by <out2>, but read1 output is not specified by <out1>")
        if args.stdout:
            out1 = "/dev/stdout"
        elif mode != "compare":
            _die("Please specify output file by <out1>, or enable --stdout if you want to write STDOUT")
    if mode == "compress":
        if args.out2:
            _die("In compress mode, only one RFQ output file is allowed, but you specified <out2>")
        if is_fastq_file(out1):
            _die("In compress mode, the output should not be a FASTQ file. Expect a .rfq or .rfq.xz file, but got " + out1)
        if is_rfq_file(in1):
            _die("In compress mode, the input should not be a RFQ file. Expect a .fq or .fq.gz file, but got " + in1)
        if args.in2 and is_rfq_file(args.in2):
            _die("In compress mode, the read2 input should not be a RFQ file.")
    if mode == "decompress":
        if args.in2:
            _die("In decompress mode, only one RFQ input file is allowed, but you specified <in2>")
        if is_fastq_file(in1):
            _die("In decompress mode, the input should not be a FASTQ file. Expect a .rfq or .rfq.xz file, but got " + in1)
        if is_rfq_file(out1):
            _die("In decompress mode, the output should not be a RFQ file. Expect a .fq or .fq.gz file, but got " + out1)
        if args.out2 and is_rfq_file(args.out2):
            _die("In decompress mode, the read2 output should not be a RFQ file.")
    if mode == "compare":
        if args.stdin:
            rfq_compare = "/dev/stdin"
        if not rfq_compare:
            _die("In compare mode, you should specify the RFQ file to compare by <rfq_to_compare>")
        if out1 or args.out2:
            _die("In compare mode, you cannot specify the output by <out1> or <out2>")
        if rfq_compare != "/dev/stdin" and not os.path.exists(rfq_compare):
            _die("Failed to open file: %s" % rfq_compare)
    if chunk_size < 10000:
        _die("chunk size cannot be less than 10 kb")
    if chunk_size > 500000000:
        _die("chunk size cannot be greater than 500,000 kb")
    if (in1.endswith(".xz") or rfq_compare.endswith(".xz")) and args.stdin:
        _die("STDIN cannot be read when the input is a .xz file")
    if out1.endswith(".xz") and args.stdout:
        _die("STDOUT cannot be written when the output is a .xz file")

    if args.profile:
        os.environ["REPAQ_PROFILE"] = "1"
    if engine is None:
        engine = get_engine(args.engine)

    if args.num_shards > 0 and mode in ("compress", "decompress"):
        return _run_shard(args, mode, in1, out1, chunk_size, engine)
    # compare mode decodes on one engine, as in repaq_tpu.cli
    mesh = (_mesh_devices(args.mesh_devices)
            if args.mesh_devices and mode != "compare" else None)

    try:
        if mode == "compress":
            if out1.endswith(".rfqz"):
                w = RfqzWriter(out1,
                               encode_section=rfqz_section_coder(args.engine))
                _run_compress(args, in1, "", chunk_size, engine, w, mesh)
                w.close()
            elif out1.endswith(".xz"):
                xz = subprocess.Popen(
                    _xz_compress_args(compression, threads),
                    stdin=subprocess.PIPE,
                    stdout=open(out1, "wb"),
                )
                _run_compress(args, in1, "", chunk_size, engine,
                              xz.stdin, mesh)
                xz.stdin.close()
                if xz.wait() != 0:
                    _die("failed to call xz, please confirm that xz is installed in your system")
            else:
                _run_compress(args, in1, out1, chunk_size, engine, None,
                              mesh)
        elif mode == "decompress":
            if in1.endswith(".rfqz"):
                _run_decompress(args, "", out1, engine, RfqzReader(in1),
                                mesh)
            elif in1.endswith(".xz"):
                xz = subprocess.Popen(
                    ["xz", "-d", "-c", in1], stdout=subprocess.PIPE
                )
                _run_decompress(args, "", out1, engine, xz.stdout, mesh)
                if xz.wait() != 0:
                    _die("failed to call xz")
            else:
                _run_decompress(args, in1, out1, engine, None, mesh)
        else:
            if rfq_compare.endswith(".rfqz"):
                result = _run_compare(args, in1, "", engine,
                                            RfqzReader(rfq_compare))
            elif rfq_compare.endswith(".xz"):
                xz = subprocess.Popen(
                    ["xz", "-d", "-c", rfq_compare], stdout=subprocess.PIPE
                )
                result = _run_compare(args, in1, "", engine, xz.stdout)
                if xz.wait() != 0:
                    _die("failed to call xz")
            else:
                result = _run_compare(args, in1, rfq_compare, engine,
                                            None)
            if result["result"] != "passed":
                return 1
    except RfqFormatError as e:
        print("ERROR: %s" % e, file=sys.stderr)
        return -1
    return 0


def _run_shard(args, mode, in1, out1, chunk_size, engine) -> int:
    """--num_shards: this shard's part of a compress or decompress, and
    on shard 0 (unless --no_assemble) the ordered assembly once every part
    exists; repaq_tpu.cli's two shard branches."""
    from .parallel import distributed as dist

    if not (0 <= args.shard < args.num_shards):
        _die("--shard must be in [0, num_shards)")
    if mode == "compress":
        if out1.endswith(".xz") or args.stdout or args.stdin:
            _die("--num_shards requires a .rfq or .rfqz output file and "
                 "file inputs")
        if in1.endswith(".gz") or (args.in2 and args.in2.endswith(".gz")):
            _die("--num_shards requires non-gz inputs (byte-range plan)")
    else:
        if not in1.endswith(".rfq") or args.stdin:
            _die("--num_shards decompress requires a plain .rfq input file "
                 "(chunk-index scan; .xz/.rfqz streams are serial)")
        if args.stdout or out1.endswith(".gz") or (
            args.out2 and args.out2.endswith(".gz")
        ):
            _die("--num_shards decompress requires plain (non-gz) FASTQ "
                 "output files")
    outs = [out1] + ([args.out2] if mode == "decompress" and args.out2
                     else [])
    pe = bool(args.in2 or args.interleaved_in)
    try:
        if mode == "decompress":
            dist.decompress_distributed(
                in1, out1, args.out2, num_processes=args.num_shards,
                process_id=args.shard, engine=engine, workers=args.workers,
                assemble=False,
            )
        elif pe:
            dist.compress_pe_distributed(
                in1, args.in2, out1, chunk_size=chunk_size,
                num_processes=args.num_shards, process_id=args.shard,
                engine=engine, workers=args.workers, assemble=False,
                interleaved=args.interleaved_in, verify=args.verify,
                fast_verify=args.fast_verify,
            )
        else:
            dist.compress_se_distributed(
                in1, out1, chunk_size=chunk_size,
                num_processes=args.num_shards, process_id=args.shard,
                engine=engine, workers=args.workers, assemble=False,
                verify=args.verify, fast_verify=args.fast_verify,
            )
        if args.shard == 0 and not args.no_assemble:
            # ranks may run concurrently (other processes or hosts on a
            # shared filesystem): wait for every part before the ordered
            # concatenation
            _wait_for_parts(["%s.part%d" % (o, pid) for o in outs
                             for pid in range(args.num_shards)])
            if mode == "decompress":
                for o in outs:
                    dist.assemble_fastq_parts(o, args.num_shards)
                return 0
            if pe:
                header = dist.derive_header_pe(
                    in1, args.in2, chunk_size, engine, args.interleaved_in)
            else:
                header = dist.derive_header(in1, chunk_size, engine)
            dist.assemble_parts(out1, header.to_bytes(), args.num_shards,
                                rfqz=out1.endswith(".rfqz"))
    except RfqFormatError as e:
        print("ERROR: %s" % e, file=sys.stderr)
        return -1
    return 0


def _mesh_devices(n: int) -> list:
    """The devices --mesh_devices n names: every CUDA device torch sees
    for n < 0, else the first min(n, count), as repaq_tpu.cli does."""
    from .parallel import mesh_engine

    devices = mesh_engine.cuda_devices()
    if not devices:
        _die("--mesh_devices needs CUDA devices, and torch sees none (the "
             "mesh never runs on the CPU)")
    return devices if n < 0 else devices[:n]


def _run_compress(args, in1, out1, chunk_size, engine, out_stream, mesh):
    if mesh:
        from .parallel.mesh_engine import compress_pe_mesh, compress_se_mesh

        if args.in2 or args.interleaved_in:
            compress_pe_mesh(
                in1, args.in2, out1, chunk_size=chunk_size,
                interleaved=args.interleaved_in, engine=engine,
                out_stream=out_stream, devices=mesh, verify=args.verify,
                fast_verify=args.fast_verify, workers=args.workers,
            )
        else:
            compress_se_mesh(
                in1, out1, chunk_size=chunk_size, engine=engine,
                out_stream=out_stream, devices=mesh, verify=args.verify,
                fast_verify=args.fast_verify, workers=args.workers,
            )
        return
    if args.in2 or args.interleaved_in:
        pipeline.compress_pe(
            in1,
            args.in2,
            out1,
            chunk_size=chunk_size,
            interleaved=args.interleaved_in,
            verify=args.verify,
            fast_verify=args.fast_verify,
            engine=engine,
            out_stream=out_stream,
            profile=args.profile,
            workers=args.workers,
        )
    else:
        pipeline.compress_se(
            in1,
            out1,
            chunk_size=chunk_size,
            verify=args.verify,
            fast_verify=args.fast_verify,
            engine=engine,
            out_stream=out_stream,
            profile=args.profile,
            workers=args.workers,
        )


def _run_decompress(args, in1, out1, engine, in_stream, mesh):
    if mesh:
        from .parallel.mesh_engine import decompress_se_mesh

        decompress_se_mesh(in1, out1, engine=engine, in_stream=in_stream,
                           devices=mesh, out2=args.out2 or "",
                           workers=args.workers)
        return
    if args.out2:
        pipeline.decompress_pe(in1, out1, args.out2, engine=engine,
                               in_stream=in_stream, workers=args.workers)
    else:
        pipeline.decompress(in1, out1, engine=engine, in_stream=in_stream,
                            workers=args.workers)


def _run_compare(args, in1, rfq, engine, in_stream):
    if args.in2:
        return pipeline.compare_pe(
            in1, args.in2, rfq, args.json_compare_result, engine=engine,
            in_stream=in_stream,
        )
    return pipeline.compare(
        in1, rfq, args.json_compare_result, engine=engine, in_stream=in_stream
    )


def _die(msg: str) -> None:
    print("ERROR: %s" % msg, file=sys.stderr)
    raise SystemExit(-1)


if __name__ == "__main__":
    sys.exit(main())
