#!/usr/bin/env python3
"""Where the gap/run parse's time goes (``kernels.qualcol_parse`` and
``kernels.positions_parse``, repaq_tpu_torch/csrc/parse.cu) on one NVIDIA
GPU, at one real SE and one real PE chunk's calls recorded through
repaq_tpu_torch.cli.main (chip_smoke.chunk_calls, pe_chunk_calls).

    python3 tools/profile_parse.py [--tree DIR ...]

For each call: the wrapper's CUDA-event time (chip_smoke.cuda_ms: median
of 15, the L2 flushed) and its device operations' mean time under
torch.profiler over 20 calls (the zero fill and the parse kernel apart).
With ``--tree`` each DIR's package (an earlier design, or a copy of this
tree with parse.cu edited) is built by that tree's own ops/_build.py into
its own _build/ and bound by it, held exact against the plain version
(every output) and timed in turns with this tree's build (A B ... B A),
each launched as the wrapper launches it (kernels._parse_launch). Every
time is printed beside the card's name and power limit. The last line of
output is one JSON object.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tree_library(tree: str):
    """The kernel library of another checkout, built and bound by its own
    repaq_tpu_torch/ops/_build.py."""
    path = os.path.join(os.path.abspath(tree), "repaq_tpu_torch", "ops",
                        "_build.py")
    spec = importlib.util.spec_from_file_location(
        "_build_of_%d" % abs(hash(path)), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.library()


def launcher(lib, entry: str, args):
    """A function of no arguments that runs entry on args as its wrapper
    does (one zero fill, one launch), with lib's build."""
    from repaq_tpu_torch.ops import kernels as TK

    if entry == "qualcol_parse":
        buf, qual_len, nbins, tok_cap, esc_cap = args
        return lambda: TK._parse_launch(entry, buf, nbins, qual_len, tok_cap,
                                        esc_cap, lib=lib)
    buf, valid_len, cap = args
    return lambda: TK._parse_launch(entry, buf, -1, valid_len, cap, 0,
                                    lib=lib)[:2]


def kernel_split(run, calls: int = 20) -> dict:
    """{device operation: mean us a call} of run() under torch.profiler."""
    import torch
    from torch.autograd import DeviceType

    run()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    us = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = "parse_kernel" if "parse_kernel" in e.name else e.name[:40]
            us[name] = us.get(name, 0.0) + e.time_range.elapsed_us() / calls
    return us


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="another checkout whose parse.cu is timed in turns")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("profile_parse: torch sees no CUDA device")
        return 2
    import chip_smoke as cs
    from repaq_tpu_torch.ops import _build
    from repaq_tpu_torch.ops import kernels as TK

    dev = torch.device("cuda:0")
    card = cs.card_line()
    libs = {"this tree": _build.library()}
    for tree in args.tree:
        libs[os.path.basename(os.path.normpath(tree))] = tree_library(tree)
    print("tiles of stream bytes: %s" % ", ".join(
        "%s %d" % (name, lib.repaq_parse_tile())
        for name, lib in libs.items()))
    se, pe = cs.chunk_calls(dev), cs.pe_chunk_calls(dev)
    res = {"card": card}
    for entry in ("qualcol_parse", "positions_parse"):
        for tag, call in (("SE", se[entry][0]), ("PE", pe[entry])):
            label = "%s %s (%d stream bytes of %d)" % (
                entry, tag, call[1], call[0].shape[0])
            row = res[label] = {
                "ms": cs.cuda_ms(lambda: getattr(TK, entry)(*call)),
                "kernels_us": kernel_split(lambda: getattr(TK, entry)(*call))}
            print("%s: %.4f ms; device operations (mean us a call) %s; on %s"
                  % (label, row["ms"], "; ".join(
                      "%s %.2f" % kv for kv in row["kernels_us"].items()),
                     card), flush=True)
            if len(libs) == 1:
                continue
            want = cs.parse_plain(entry)(*call)
            runs = {name: launcher(lib, entry, call)
                    for name, lib in libs.items()}
            for name, run in runs.items():
                if not all(torch.equal(g, w) for g, w in zip(run(), want)):
                    raise RuntimeError("%s's build differs from the plain "
                                       "version at %s" % (name, label))
            turns = {name: [] for name in runs}
            for name in list(runs) + list(runs)[::-1]:
                turns[name].append(cs.cuda_ms(runs[name]))
            row["trees_ms"] = turns
            print("%s in turns: %s; on %s" % (label, "; ".join(
                "%s %s ms" % (n, ", ".join("%.4f" % t for t in ts))
                for n, ts in turns.items()), card), flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
