#!/usr/bin/env python3
"""Where the gap/run parse's time goes (``kernels.qualcol_parse`` and
``kernels.positions_parse``, repaq_tpu_torch/csrc/parse.cu) on one NVIDIA
GPU, at one real SE and one real PE chunk's calls recorded through
repaq_tpu_torch.cli.main (chip_smoke.chunk_calls, pe_chunk_calls).

    python3 tools/profile_parse.py [--tree DIR ...]

For each call: the wrapper's CUDA-event time (chip_smoke.cuda_ms: median
of 15, the L2 flushed) and its device operations' mean time under
torch.profiler over 20 calls (the status memset or zero fill and the
parse kernel apart). With ``--tree`` each DIR's package (an earlier
design, or a copy of this tree with parse.cu edited) is imported under a
name of its own, so that its ops/_build.py builds its sources into its own
_build/, held exact against the plain version (every output) and timed in
turns with this tree's build (A B ... B A), each launched through its own
tree's kernels._parse_launch. Every build's parse kernel is also compiled
alone with ``nvcc -Xptxas -v``: its registers, spills and shared memory,
and the blocks an SM those allow. Every time is printed beside the card's
name and power limit. The last line of output is one JSON object.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tree_kernels(tree: str):
    """Another checkout's ops.kernels, its package imported under a name
    of its own (its _build.py then builds that tree's sources)."""
    pkg = os.path.join(os.path.abspath(tree), "repaq_tpu_torch")
    name = "_parse_tree_%d" % len(sys.modules)
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(name + ".ops.kernels")


def ptxas_info(tree: str) -> dict:
    """The parse kernel's registers, spill bytes and shared memory as
    ``nvcc -Xptxas -v`` reports them for tree's parse.cu (the package's
    build flags), and the blocks of 256 threads an H100 SM holds by them
    (65,536 registers in units of 8 a thread, 228 KB of shared memory with
    1 KB kept a block, 2,048 threads)."""
    from repaq_tpu_torch.ops import _build

    src = os.path.join(os.path.abspath(tree), "repaq_tpu_torch", "csrc",
                       "parse.cu")
    with tempfile.TemporaryDirectory() as tmp:
        r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas",
                            "-v", "-c", src, "-o",
                            os.path.join(tmp, "parse.o")],
                           capture_output=True, text=True)
    out = r.stdout + r.stderr
    lines = out.splitlines()
    at = next(i for i, ln in enumerate(lines)
              if "Compiling entry function" in ln and "parse_kernel" in ln)
    text = "\n".join(lines[at:at + 4])
    info = {
        "registers": int(re.search(r"Used (\d+) registers", text).group(1)),
        "spill_stores": int(re.search(r"(\d+) bytes spill stores",
                                      text).group(1)),
        "spill_loads": int(re.search(r"(\d+) bytes spill loads",
                                     text).group(1)),
        "smem": int(re.search(r"(\d+) bytes smem", text).group(1)),
    }
    regs = -(-info["registers"] // 8) * 8
    info["blocks_per_sm"] = min(65536 // (regs * 256),
                                (228 * 1024) // (info["smem"] + 1024),
                                2048 // 256)
    return info


def launcher(mod, entry: str, args):
    """A function of no arguments that runs entry on args as mod's
    wrapper does (mod._parse_launch of its tree)."""
    if entry == "qualcol_parse":
        buf, qual_len, nbins, tok_cap, esc_cap = args
        return lambda: mod._parse_launch(entry, buf, nbins, qual_len,
                                         tok_cap, esc_cap)
    buf, valid_len, cap = args
    return lambda: mod._parse_launch(entry, buf, -1, valid_len, cap, 0)[:2]


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
    from repaq_tpu_torch.ops import kernels as TK

    dev = torch.device("cuda:0")
    card = cs.card_line()
    mods = {"this tree": TK}
    trees = {"this tree": ROOT}
    for tree in args.tree:
        label = os.path.basename(os.path.normpath(tree))
        mods[label], trees[label] = tree_kernels(tree), tree
    res = {"card": card, "builds": {}}
    for label, mod in mods.items():
        info = ptxas_info(trees[label])
        info["tile"] = int(mod._build.library().repaq_parse_tile())
        res["builds"][label] = info
        print("%s: parse_kernel %d registers, %d / %d bytes spilled "
              "(stores / loads), %d bytes of shared memory, %d blocks an SM "
              "by them, tiles of %d stream bytes" % (
                  label, info["registers"], info["spill_stores"],
                  info["spill_loads"], info["smem"], info["blocks_per_sm"],
                  info["tile"]), flush=True)
    print("this tree's persistent wave: %d blocks (the runtime's occupancy "
          "times the SMs)" % TK.parse_wave())
    se, pe = cs.chunk_calls(dev), cs.pe_chunk_calls(dev)
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
            if len(mods) == 1:
                continue
            want = cs.parse_plain(entry)(*call)
            runs = {name: launcher(mod, entry, call)
                    for name, mod in mods.items()}
            for name, run in runs.items():
                if not all(torch.equal(g, w) for g, w in zip(run(), want)):
                    raise RuntimeError("%s's build differs from the plain "
                                       "version at %s" % (name, label))
                row.setdefault("trees_kernels_us", {})[name] = kernel_split(
                    run)
            turns = {name: [] for name in runs}
            for name in list(runs) + list(runs)[::-1]:
                turns[name].append(cs.cuda_ms(runs[name]))
            row["trees_ms"] = turns
            print("%s in turns: %s; on %s" % (label, "; ".join(
                "%s %s ms" % (n, ", ".join("%.4f" % t for t in ts))
                for n, ts in turns.items()), card), flush=True)
            print("%s device operations by build (mean us a call): %s" % (
                label, "; ".join("%s: %s" % (n, ", ".join(
                    "%s %.2f" % kv for kv in us.items()))
                    for n, us in row["trees_kernels_us"].items())),
                flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
