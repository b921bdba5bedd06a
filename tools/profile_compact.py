#!/usr/bin/env python3
"""Where ``kernels.bucket_compact``'s time goes on one NVIDIA GPU, at every
call of one SE chunk as the device path makes them (chip_smoke.compact_shapes:
a chunk of phase 4's corpus through repaq_tpu_torch.cli.main, its grouping
of 12,582,912 bin ids, its N flags, its coordinates' count >= 2
compaction and its decode's token starts with their windows; and the
quality and N streams' count >= 2 compactions that the emission's plain
versions make at its calls).

    python3 tools/profile_compact.py [--tree DIR] [--ablate]

For each call: its CUDA-event median of 15 runs with the L2 flushed by
writes (chip_smoke.cuda_ms, as phase 2 times it) and by reads (clean=True:
no dirty line left for the call to write back), a call's time over 48
calls in a row (chip_smoke.back_to_back_ms, on one input set, which may
stay in the L2: a call without the fixed cost of one event-timed launch),
and each device kernel's time under torch.profiler (a mask's one pass; the
ids' count and scatter), a median over 15 calls, each after a clean flush.

``--tree DIR`` times the package of another checkout (an earlier design
unpacked by ``git archive`` into an ignored directory) at this checkout's
shapes, so two designs can be read in turns, one process each.

``--ablate`` builds repaq_tpu_torch/csrc/compact.cu with its switches
(one nvcc each, in parallel, into a temporary directory), holds each build
exact against the plain version and times them in turns (A B C C B A) at
the chunk's calls and at the grouping's ids spread over 2, 4, 6, 8 and 9
buckets (the route threshold: the register route takes up to 8):
  as built        a mask in one pass, ids up to 8 buckets counted in
                  registers in two launches, more by the match route in
                  three;
  ids by match    -DREPAQ_COMPACT_REG_MAX=0: every id call on the match
                  route (__match_any_sync, a one-block scan);
  three passes    -DREPAQ_COMPACT_THREE_PASS: every call, masks too, on
                  the match route's three launches (a mask a ballot a
                  round).
The last line of output is one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "repaq_tpu_torch", "csrc", "compact.cu")
# name -> (source, nvcc flags) of each build --ablate times
VARIANTS = {"as built": (SRC, []),
            "ids by match": (SRC, ["-DREPAQ_COMPACT_REG_MAX=0"]),
            "three passes": (SRC, ["-DREPAQ_COMPACT_THREE_PASS"])}
THRESHOLD_BUCKETS = (2, 4, 6, 8, 9)
SETS = 8


def smoke():
    """This checkout's chip_smoke.py as a module (its shapes, timers and
    references), whichever tree's package is imported."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    return cs


def kernel_split(fn, runs: int = 15) -> dict:
    """{kernel name: median device us} of fn()'s compaction kernels over
    `runs` calls, each after a clean L2 flush (a read of 64 MB)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.zeros(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = {}
    for _ in range(runs):
        flush.sum()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        for e in prof.events():
            hit = re.search(r"\w*compact\w*_kernel(<\w+>)?", e.name)
            if e.device_type == DeviceType.CUDA and hit:
                times.setdefault(hit.group(0), []).append(
                    e.time_range.elapsed_us())
    return {k: statistics.median(v) for k, v in times.items()}


def build(tmp: str, variants: dict) -> dict:
    """name -> loaded library of each (source, flags) build."""
    from repaq_tpu_torch.ops import _build

    procs = {}
    for i, (name, (src, flags)) in enumerate(variants.items()):
        so = os.path.join(tmp, "v%d.so" % i)
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-shared", "-o", so,
             src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    libs = {}
    for name, (so, p) in procs.items():
        out = p.communicate()[0].decode(errors="replace")
        if p.returncode:
            raise RuntimeError("nvcc failed on %r:\n%s" % (name, out))
        lib = libs[name] = ctypes.CDLL(so)
        lib.repaq_bucket_compact.argtypes = [vp, ci, ll, ci, ll, ci, vp, vp,
                                             vp, vp, vp, vp, vp]
        lib.repaq_bucket_compact.restype = ci
        for entry in (lib.repaq_bucket_compact_scratch_words,
                      lib.repaq_bucket_compact_status_words):
            entry.argtypes = [ll, ci, ci]
            entry.restype = ll
    return libs


def launcher(lib, bucket, k, cap, fill, payload):
    """A function that launches `lib`'s compaction on these arguments as
    the package's wrapper does (status words zeroed once, which every
    launch leaves zeroed; int32 scratch for the match route) and returns
    its outputs."""
    import torch

    dev = bucket.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    n, mask = bucket.shape[0], int(bucket.dtype == torch.bool)
    status = torch.zeros(max(1, lib.repaq_bucket_compact_status_words(
        n, k, mask)), dtype=torch.int64, device=dev)
    words = lib.repaq_bucket_compact_scratch_words(n, k, mask)

    def run():
        idx = torch.empty(cap, dtype=torch.int32, device=dev)
        pay = (None if payload is None
               else torch.empty(cap, dtype=torch.int32, device=dev))
        counts = torch.empty(k, dtype=torch.int32, device=dev)
        scratch = torch.empty(max(words, 1), dtype=torch.int32, device=dev)
        rc = lib.repaq_bucket_compact(
            bucket.data_ptr(), mask, n, k, cap, fill,
            None if payload is None else payload.data_ptr(), idx.data_ptr(),
            None if pay is None else pay.data_ptr(), counts.data_ptr(),
            scratch.data_ptr(), status.data_ptr(), stream)
        if rc:
            raise RuntimeError("bucket_compact failed to launch: %d" % rc)
        return tuple(t for t in (idx, pay, counts) if t is not None)
    return run


def threshold_shapes(dev, seed: int = 1801) -> list:
    """The grouping's 12,582,912 ids with its 86% dropped and the rest
    spread evenly over k buckets, for k in THRESHOLD_BUCKETS."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    n = 12_582_912
    out = []
    for k in THRESHOLD_BUCKETS:
        ids = np.where(rng.random(n) < 0.86, 255,
                       rng.integers(0, k, size=n)).astype(np.uint8)
        bucket = torch.from_numpy(ids).to(dev)
        out.append(("grouping ids over %d buckets" % k, bucket, k,
                    int((ids < k).sum()), n, None, None))
    return out


def ablate(cs, TK, dev, variants: dict = VARIANTS) -> dict:
    import torch

    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp, variants)
        for label, bucket, k, cap, fill, payload, _parent in (
                cs.compact_shapes(dev) + threshold_shapes(dev)):
            want = tuple(t for t in TK.bucket_compact_plain(
                bucket, k, cap, fill, payload) if t is not None)
            runs = {}
            for v, lib in libs.items():
                runs[v] = launcher(lib, bucket, k, cap, fill, payload)
                got = runs[v]()
                torch.cuda.synchronize()
                if cs.max_abs_err(got, want) != 0:
                    raise RuntimeError("%s is not exact at %s" % (v, label))
            times = {v: [] for v in libs}
            for v in list(libs) + list(reversed(libs)):
                times[v].append(cs.cuda_ms(runs[v]))
            split = {v: sum(kernel_split(runs[v]).values()) for v in libs}
            report[label] = {v: {"ms": times[v], "kernels_us": split[v]}
                             for v in libs}
            for v, ts in times.items():
                print("ablate %-62s %-13s %s ms; kernels %.2f us" % (
                    label, v, ", ".join("%.4f" % t for t in ts), split[v]),
                    flush=True)
            del runs, want
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=ROOT,
                    help="checkout whose repaq_tpu_torch is timed")
    ap.add_argument("--ablate", action="store_true",
                    help="time builds of compact.cu with its switches set")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        print("profile_compact: torch sees no CUDA device")
        return 2
    cs = smoke()
    from repaq_tpu_torch.ops import kernels as TK

    dev = torch.device("cuda:0")
    print("card: %s; tree %s" % (cs.card_line(), os.path.abspath(args.tree)))
    res = {}
    for label, bucket, k, cap, fill, payload, _parent in cs.compact_shapes(dev):
        def call():
            return TK.bucket_compact(bucket, k, cap, fill, payload)

        row = {"ms": cs.cuda_ms(call), "clean_ms": cs.cuda_ms(call, clean=True),
               "back_to_back_ms": cs.back_to_back_ms(lambda _i: call(), SETS),
               "kernels_us": kernel_split(call)}
        res[label] = row
        print("%s: %.4f ms (clean flush %.4f, back to back %.4f); kernels "
              "%s us" % (label, row["ms"], row["clean_ms"],
                         row["back_to_back_ms"],
                         ", ".join("%s %.2f" % kv
                                   for kv in row["kernels_us"].items())),
              flush=True)
    if args.ablate:
        res["ablate"] = ablate(cs, TK, dev)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
