"""Command-line interface of the PyTorch/CUDA port:
``python -m repaq_tpu_torch.cli``, flag-compatible with ``repaq_tpu.cli``
for ``.rfq``, ``.rfq.xz`` and ``.rfqz`` files.

It reuses the JAX package's argument parser, validation messages and
pipeline functions (none of which import JAX) and binds ``--engine device``
to the torch engine on ``cuda:0``. ``auto`` picks that engine when CUDA is
available and the host ``vectorized`` engine otherwise. The device engine
never runs on the CPU: without CUDA, ``--engine device`` exits non-zero.
Under ``--engine device`` a ``.rfqz`` output's rANS sections are coded on
``cuda:0`` too (``ops/rans_device.py``), where the JAX CLI uses its device
coder; ``.rfqz`` input is read with the host decoder, as there.
"""

from __future__ import annotations

import functools
import os
import subprocess
import sys

import torch

from repaq_tpu import cli as _base
from repaq_tpu import pipeline
from repaq_tpu.format.header import RfqFormatError
from repaq_tpu.format.rfqz import RfqzReader, RfqzWriter

_die = _base._die

# features of the JAX CLI the port does not have yet, by ROADMAP item
_NOT_YET = {
    "--mesh_devices": "A8 (multi-GPU)",
    "--num_shards": "A10 (multi-host)",
}


def get_engine(name: str = "auto") -> pipeline.EngineConfig:
    """Engine by name: 'device' is the torch engine on cuda:0 (no CUDA is
    an error), 'auto' is 'device' when CUDA is available and 'vectorized'
    otherwise, REPAQ_ENGINE overrides 'auto' as in the JAX CLI."""
    if name == "auto":
        name = os.environ.get("REPAQ_ENGINE", "auto")
    if name == "auto":
        name = "device" if torch.cuda.is_available() else "vectorized"
    if name == "device":
        if not torch.cuda.is_available():
            _die("--engine device needs a CUDA device, and torch sees none "
                 "(the torch engine never runs on the CPU; use --engine "
                 "vectorized for the host codec)")
        from .codec.device_engine import make_engine_config

        return make_engine_config("cuda:0")
    return pipeline.get_engine(name)


def rfqz_section_coder(engine_name: str):
    """The section coder a .rfqz output uses: the port's device rANS on
    cuda:0 under --engine device, where the JAX CLI uses its own
    (repaq_tpu/cli.py:398-411), else None, the host coder."""
    if engine_name != "device":
        return None
    from .ops.rans_device import encode_section_device

    return functools.partial(encode_section_device, device="cuda:0")


def _reject_not_yet(what: str) -> None:
    _die("%s is not ported to repaq_tpu_torch yet (ROADMAP %s); use "
         "python -m repaq_tpu.cli for it" % (what, _NOT_YET[what]))


def main(argv: list[str] | None = None,
         engine: pipeline.EngineConfig | None = None) -> int:
    """CLI entry. engine: run this EngineConfig instead of the one
    --engine names (a caller that reads the engine's stats afterwards)."""
    if argv is None:
        argv = sys.argv[1:]
    if len(argv) == 1 and argv[0] == "test":
        return _base.self_test()
    args = _base.build_parser().parse_args(argv)
    if args.workers < 1:
        args.workers = max(1, min(8, os.cpu_count() or 1))
    if args.mesh_devices:
        _reject_not_yet("--mesh_devices")
    if args.num_shards > 0:
        _reject_not_yet("--num_shards")

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
        if _base.is_fastq_file(out1):
            _die("In compress mode, the output should not be a FASTQ file. Expect a .rfq or .rfq.xz file, but got " + out1)
        if _base.is_rfq_file(in1):
            _die("In compress mode, the input should not be a RFQ file. Expect a .fq or .fq.gz file, but got " + in1)
        if args.in2 and _base.is_rfq_file(args.in2):
            _die("In compress mode, the read2 input should not be a RFQ file.")
    if mode == "decompress":
        if args.in2:
            _die("In decompress mode, only one RFQ input file is allowed, but you specified <in2>")
        if _base.is_fastq_file(in1):
            _die("In decompress mode, the input should not be a FASTQ file. Expect a .rfq or .rfq.xz file, but got " + in1)
        if _base.is_rfq_file(out1):
            _die("In decompress mode, the output should not be a RFQ file. Expect a .fq or .fq.gz file, but got " + out1)
        if args.out2 and _base.is_rfq_file(args.out2):
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

    try:
        if mode == "compress":
            if out1.endswith(".rfqz"):
                w = RfqzWriter(out1,
                               encode_section=rfqz_section_coder(args.engine))
                _base._run_compress(args, in1, "", chunk_size, engine, w)
                w.close()
            elif out1.endswith(".xz"):
                xz = subprocess.Popen(
                    _base._xz_compress_args(compression, threads),
                    stdin=subprocess.PIPE,
                    stdout=open(out1, "wb"),
                )
                _base._run_compress(args, in1, "", chunk_size, engine,
                                    xz.stdin)
                xz.stdin.close()
                if xz.wait() != 0:
                    _die("failed to call xz, please confirm that xz is installed in your system")
            else:
                _base._run_compress(args, in1, out1, chunk_size, engine, None)
        elif mode == "decompress":
            if in1.endswith(".rfqz"):
                _base._run_decompress(args, "", out1, engine,
                                      RfqzReader(in1))
            elif in1.endswith(".xz"):
                xz = subprocess.Popen(
                    ["xz", "-d", "-c", in1], stdout=subprocess.PIPE
                )
                _base._run_decompress(args, "", out1, engine, xz.stdout)
                if xz.wait() != 0:
                    _die("failed to call xz")
            else:
                _base._run_decompress(args, in1, out1, engine, None)
        else:
            if rfq_compare.endswith(".rfqz"):
                result = _base._run_compare(args, in1, "", engine,
                                            RfqzReader(rfq_compare))
            elif rfq_compare.endswith(".xz"):
                xz = subprocess.Popen(
                    ["xz", "-d", "-c", rfq_compare], stdout=subprocess.PIPE
                )
                result = _base._run_compare(args, in1, "", engine, xz.stdout)
                if xz.wait() != 0:
                    _die("failed to call xz")
            else:
                result = _base._run_compare(args, in1, rfq_compare, engine,
                                            None)
            if result["result"] != "passed":
                return 1
    except RfqFormatError as e:
        print("ERROR: %s" % e, file=sys.stderr)
        return -1
    return 0


if __name__ == "__main__":
    sys.exit(main())
