#!/usr/bin/env python3
"""Where ``kernels.bucket_compact``'s time goes on one NVIDIA GPU: its
three kernels (csrc/compact.cu: the count pass, the one-block scan of the
counts, the scatter pass) at the main path's shapes (chip_smoke.
compact_shapes: an SE chunk's grouping of 12,582,912 bin ids, its N
flags, its decode's 2,359,296 token starts with their windows).

    python3 tools/profile_compact.py [--tree DIR]

For each shape: the call's CUDA-event median of 15 runs with the L2
flushed by writes (chip_smoke.cuda_ms, as phase 2 times it) and by reads
(clean=True: no dirty line left for the call to write back), and each
kernel's device time under torch.profiler, a median over 15 calls, each
after a clean flush. ``--tree DIR`` takes the package and chip_smoke.py
of another checkout (an earlier design unpacked by ``git archive`` into
an ignored directory), so two designs can be read in turns, one process
each. The last line of output is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kernel_split(fn, runs: int = 15) -> dict:
    """{kernel name: median device us} of fn()'s kernels over `runs`
    calls, each after a clean L2 flush (a read of 64 MB)."""
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
            at = e.name.find("bucket_compact_")
            if e.device_type == DeviceType.CUDA and at >= 0:
                key = e.name[at:].split("(")[0]
                times.setdefault(key, []).append(e.time_range.elapsed_us())
    return {k: statistics.median(v) for k, v in times.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=ROOT,
                    help="checkout whose repaq_tpu_torch is timed")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        print("profile_compact: torch sees no CUDA device")
        return 2
    import chip_smoke as cs
    from repaq_tpu_torch.ops import kernels as TK

    dev = torch.device("cuda:0")
    print("card: %s; tree %s" % (cs.card_line(), os.path.abspath(args.tree)))
    res = {}
    for label, bucket, k, cap, fill, payload, _parent in cs.compact_shapes(dev):
        def call():
            return TK.bucket_compact(bucket, k, cap, fill, payload)

        row = {"ms": cs.cuda_ms(call), "clean_ms": cs.cuda_ms(call, clean=True),
               "kernels_us": kernel_split(call)}
        res[label] = row
        print("%s: %.4f ms (clean flush %.4f); kernels %s us"
              % (label, row["ms"], row["clean_ms"],
                 ", ".join("%s %.2f" % kv for kv in row["kernels_us"].items())))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
