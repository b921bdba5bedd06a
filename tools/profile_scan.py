#!/usr/bin/env python3
"""Where the run-boundary scan kernel's time goes, on one NVIDIA GPU.

    python3 tools/profile_scan.py

Builds repaq_tpu_torch/csrc/scan.cu several ways with the package's nvcc
flags (one nvcc each, in parallel, into a temporary directory):
  as built                  the kernel the package builds, 256 threads of
                            4 vectors (4,096 elements) a tile;
  t128 v4, t256 v8, t512 v4, t512 v8
                            -DREPAQ_SCAN_THREADS / -DREPAQ_SCAN_VECS: other
                            tile shapes (2,048 to 16,384 elements);
  no look-back              -DREPAQ_SCAN_NO_LOOKBACK: every tile starts
                            from the identity (output wrong on purpose).
Every build but the last is held exact against torch's scans. Each is
timed, both directions (running max, suffix min), at the main path's
sizes (the SE and PE quality streams' 2,097,152 elements, the SE decode's
2,359,296 tokens, a whole 11,829,248-base chunk, the SE coordinates'
(2, 98304) rows) three ways:
  one launch         the zeroing of the status words and the kernel, a
                     CUDA-event median of 15 runs with the L2 flushed
                     (chip_smoke.cuda_ms), as chip_smoke.py times it;
  back to back       48 of those in a row over 8 input sets
                     (chip_smoke.back_to_back_ms): a launch's time without
                     the fixed cost of one event-timed launch;
  kernel alone       48 kernels in a row over 8 input sets on status words
                     zeroed before the timing: the zeroing taken out too.
The builds are timed in turns (A B .. B A). The zeroing alone is printed
too. The last line of output is one JSON object.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "repaq_tpu_torch", "csrc", "scan.cu")


def _shape(t: int, v: int) -> list:
    return ["-DREPAQ_SCAN_THREADS=%d" % t, "-DREPAQ_SCAN_VECS=%d" % v]


VARIANTS = {"as built": [], "t128 v4": _shape(128, 4),
            "t256 v8": _shape(256, 8), "t512 v4": _shape(512, 4),
            "t512 v8": _shape(512, 8),
            "no look-back": ["-DREPAQ_SCAN_NO_LOOKBACK"]}
INEXACT = ("no look-back",)
SHAPES = [(2_097_152,), (2_359_296,), (11_829_248,), (2, 98_304)]
SETS, RUNS = 8, 48


def build(tmp: str) -> dict:
    """name -> loaded library of each variant."""
    from repaq_tpu_torch.ops import _build

    procs = {}
    for i, (name, flags) in enumerate(VARIANTS.items()):
        so = os.path.join(tmp, "v%d.so" % i)
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-shared", "-o", so,
             SRC], stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    libs = {}
    for name, (so, p) in procs.items():
        out = p.communicate()[0].decode(errors="replace")
        if p.returncode:
            raise RuntimeError("nvcc failed on %r:\n%s" % (name, out))
        lib = libs[name] = ctypes.CDLL(so)
        lib.repaq_scan_i32.argtypes = [vp, vp, ll, ll, ci, vp, vp]
        lib.repaq_scan_i32.restype = ci
        lib.repaq_scan_status_words.argtypes = [ll, ll]
        lib.repaq_scan_status_words.restype = ll
    return libs


def launcher(lib, x, suffix_min: bool, zero: bool):
    """A function of a status buffer that launches `lib`'s kernel on x,
    zeroing the status words first when `zero`, and returns its output."""
    import torch

    rows = x.shape[0] if x.dim() == 2 else 1
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream

    def run(status):
        if zero:
            status.zero_()
        rc = lib.repaq_scan_i32(x.data_ptr(), out.data_ptr(), rows,
                                x.shape[-1], int(suffix_min),
                                status.data_ptr(), stream)
        if rc:
            raise RuntimeError("the scan failed to launch: %d" % rc)
        return out

    return run


def timings(lib, xs: list, suffix_min: bool) -> dict:
    """The three readings of one build and direction, in ms."""
    import torch

    import chip_smoke as cs

    x = xs[0]
    rows = x.shape[0] if x.dim() == 2 else 1
    words = lib.repaq_scan_status_words(rows, x.shape[-1])

    def statuses(k):
        return [torch.zeros(words, dtype=torch.int64, device=x.device)
                for _ in range(k)]

    one = launcher(lib, x, suffix_min, True)
    status = statuses(1)[0]
    runs = [launcher(lib, xi, suffix_min, True) for xi in xs]
    sets = statuses(SETS)
    b2b = cs.back_to_back_ms(lambda i: runs[i](sets[i]), SETS, RUNS)
    # the kernel alone: a zeroed status buffer for every launch, the two
    # warm-up rounds of back_to_back_ms included
    bare = [launcher(lib, xi, suffix_min, False) for xi in xs]
    fresh = iter(statuses(SETS + RUNS))
    alone = cs.back_to_back_ms(lambda i: bare[i](next(fresh)), SETS, RUNS)
    return {"one_launch": cs.cuda_ms(lambda: one(status)),
            "back_to_back": b2b, "kernel_alone": alone}


def main() -> int:
    if len(sys.argv) > 1:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("profile_scan: torch sees no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repaq_tpu_torch.ops import kernels as TK

    dev = torch.device("cuda:0")
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
        for shape in SHAPES:
            rows = shape[0] if len(shape) == 2 else 0
            for name, kind, plain in (
                    ("cummax", "run_starts", TK.cummax_i32_plain),
                    ("suffix_min", "run_ends", TK.suffix_min_i32_plain)):
                xs = [torch.from_numpy(cs.scan_case(shape[-1], rows, kind,
                                                    s)).to(dev)
                      for s in range(SETS)]
                want = plain(xs[0])
                suffix = name == "suffix_min"
                for v, lib in libs.items():
                    got = launcher(lib, xs[0], suffix, True)(torch.zeros(
                        lib.repaq_scan_status_words(max(rows, 1), shape[-1]),
                        dtype=torch.int64, device=dev))
                    if v not in INEXACT and not torch.equal(got, want):
                        raise RuntimeError("%s %s is not exact at %s"
                                           % (v, name, shape))
                order = list(libs) + list(reversed(libs))
                times = {v: [] for v in libs}
                for v in order:
                    times[v].append(timings(libs[v], xs, suffix))
                bound = 1e3 * 8 * xs[0].numel() / cs.HBM_BYTES_PER_S
                key = "%s %s" % (name, shape)
                report[key] = {"bound_ms": bound, "times_ms": times}
                for v, ts in times.items():
                    print("%-24s %-13s %s (bound %.4f ms)" % (
                        key, v, "; ".join(
                            ", ".join("%s %.4f" % (k, t[k]) for k in t)
                            for t in ts), bound), flush=True)
                del xs
        words = torch.zeros(2, dtype=torch.int64, device=dev)
        report["zeroing_ms"] = cs.cuda_ms(lambda: words.zero_())
        print("one zeroing launch alone %.4f ms" % report["zeroing_ms"])
    print(cs.card_line())
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
