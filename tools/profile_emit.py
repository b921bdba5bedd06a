#!/usr/bin/env python3
"""Where the gap/run emission's time goes (``kernels.qualcol_emit`` and
``kernels.positions_emit``, repaq_tpu_torch/csrc/emit.cu) on one NVIDIA
GPU, at one real SE and one real PE chunk's calls recorded through
repaq_tpu_torch.cli.main (chip_smoke.chunk_calls, pe_chunk_calls).

    python3 tools/profile_emit.py [--tree DIR ...] [--steps]

For each call: its kept and fill tiles (the tiles up to the last kept
element, and the tiles of fill past it), the wrapper's CUDA-event time
(chip_smoke.cuda_ms: median of 15, the L2 flushed) and its device
operations' mean time under torch.profiler over 20 calls (the memset or
zero fill and the emission kernel apart). With ``--tree`` each DIR's
package (an earlier design, or a copy of this tree with emit.cu edited) is
imported under a name of its own, so that its ops/_build.py builds its
sources into its own _build/, held exact against the plain version (buffer
and total) and timed in turns with this tree's build (A B ... B A), each
launched through its own tree's kernels._emit_launch. Every build's
emission kernel is also compiled alone with ``nvcc -Xptxas -v``: its
registers, spills and shared memory, and the blocks an SM those allow.
With ``--steps``, a copy of this tree's package whose emit.cu stamps
``%globaltimer`` at each step of a tile (STEPS) is built in a temporary
directory and run at the SE calls: each step's time across the tiles (the
minimum, median, 90th percentile and maximum), from the first block's
start. Every time is printed beside the card's name and power limit. The
last line of output is one JSON object.
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
    name = "_emit_tree_%d" % len(sys.modules)
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(name + ".ops.kernels")


def ptxas_info(tree: str) -> dict:
    """{kernel: its registers, spill bytes and shared memory} as ``nvcc
    -Xptxas -v`` reports them for each emission kernel of tree's emit.cu
    (the package's build flags; one kernel, or one a tile size, by its
    mangled name), and the blocks of 256 threads an H100 SM holds by them
    (65,536 registers in units of 8 a thread, 228 KB of shared memory with
    1 KB kept a block, 2,048 threads)."""
    from repaq_tpu_torch.ops import _build

    src = os.path.join(os.path.abspath(tree), "repaq_tpu_torch", "csrc",
                       "emit.cu")
    with tempfile.TemporaryDirectory() as tmp:
        r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas",
                            "-v", "-c", src, "-o",
                            os.path.join(tmp, "emit.o")],
                           capture_output=True, text=True)
    lines = (r.stdout + r.stderr).splitlines()
    res = {}
    for at, ln in enumerate(lines):
        if "Compiling entry function" not in ln or "emit_kernel" not in ln:
            continue
        text = "\n".join(lines[at:at + 4])
        name = re.search(r"'(\S+)'", ln).group(1)
        info = {
            "registers": int(re.search(r"Used (\d+) registers",
                                       text).group(1)),
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
        res[name] = info
    return res


# The steps of a tile a stamped copy marks (thread 0, after the step): each
# is (name, the line of emit.cu the mark goes in front of).
STEPS = (
    ("staged", "    // 1. a tile of fill leaves"),
    ("segments", "    // kPer bits; element 0 starts the stream's first segment"),
    ("kinds", "    // 3. within the tile: the last break"),
    ("last-break scan", "    // the thread's head (its elements before its first break) "
     "continues"),
    ("bytes scan, value out", "    // 4. the bytes from the tile's first break on"),
    ("bytes built", "    // 5. the one look-back; the inclusive state, the total, "
     "the next ticket"),
    ("look-back", "    // the lead's run tokens, where the carried run's offset is "
     "a multiple"),
    ("lead tokens", "    // stored whole: 16-byte lines the tile owns"),
    ("stored, table", "    j = jn;\n  }"),
)


def stamped_tree(tmp: str) -> str:
    """A copy of this tree's package under tmp whose emit.cu records, for
    each tile, the %globaltimer at each of STEPS and its block, and for
    each block its start and end, read back by repaq_emit_steps."""
    import shutil

    pkg = os.path.join(tmp, "repaq_tpu_torch")
    shutil.copytree(os.path.join(ROOT, "repaq_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = os.path.join(pkg, "csrc", "emit.cu")
    with open(src) as f:
        text = f.read()
    head = ("__device__ unsigned long long g_steps[8192][%d];\n"
            "__device__ unsigned long long g_blocks[4096][2];\n"
            "__device__ __forceinline__ unsigned long long now_ns() {\n"
            "  unsigned long long t;\n"
            "  asm volatile(\"mov.u64 %%0, %%%%globaltimer;\" : \"=l\"(t));\n"
            "  return t;\n}\n" % (len(STEPS) + 1))
    text = text.replace("namespace {\n", head + "namespace {\n", 1)
    for k, (_name, line) in enumerate(STEPS):
        mark = ("    if (threadIdx.x == 0) { g_steps[j][%d] = now_ns();%s }\n"
                % (k, " g_steps[j][%d] = blockIdx.x;" % len(STEPS)
                   if k == 0 else ""))
        if line not in text:
            raise RuntimeError("emit.cu has no line %r to mark" % line)
        text = text.replace(line, mark + line, 1)
    first = "  // the first ticket, and the bin starts (the grouping's order)\n"
    end = ("      reinterpret_cast<uint4*>(p.out)[c] = make_uint4(0, 0, 0, 0);"
           "\n    }\n  }\n")
    for line, k in ((first, 0), (end, 1)):
        if line not in text:
            raise RuntimeError("emit.cu has no line %r to mark" % line)
        mark = ("  if (threadIdx.x == 0) g_blocks[blockIdx.x][%d] = now_ns();\n"
                % k)
        text = text.replace(line, mark + line if k == 0 else line + mark, 1)
    text += ('\nextern "C" int repaq_emit_steps(void* steps, void* blocks, '
             'int clear) {\n'
             '  void* p = nullptr;\n'
             '  cudaGetSymbolAddress(&p, g_steps);\n'
             '  if (clear) cudaMemset(p, 0, sizeof(g_steps));\n'
             '  else cudaMemcpy(steps, p, sizeof(g_steps), '
             'cudaMemcpyDeviceToHost);\n'
             '  cudaGetSymbolAddress(&p, g_blocks);\n'
             '  if (clear) return (int)cudaMemset(p, 0, sizeof(g_blocks));\n'
             '  return (int)cudaMemcpy(blocks, p, sizeof(g_blocks), '
             'cudaMemcpyDeviceToHost);\n}\n')
    with open(src, "w") as f:
        f.write(text)
    return tmp


def step_times(call_of: dict, card: str) -> dict:
    """Each step's time across the tiles of the SE calls, from a stamped
    copy of this tree (STEPS): {entry: {step: (min, median, p90, max)}} in
    us, a step's time from the one before (the first: from its block's
    start), and the last block's end from the first block's start."""
    import ctypes
    import tempfile

    import numpy as np
    import torch

    import chip_smoke as cs

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        mod = tree_kernels(stamped_tree(tmp))
        lib = mod._build.library()
        lib.repaq_emit_steps.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_int]
        for entry, call in call_of.items():
            run = launcher(mod, entry, call)
            want_out, want_total = cs.emit_plain(entry)(*call)
            for _ in range(3):  # the last of three calls is read
                torch.cuda.synchronize()
                lib.repaq_emit_steps(None, None, 1)
                out, total = run()
                torch.cuda.synchronize()
            if int(total) != int(want_total) or not torch.equal(out,
                                                                want_out):
                raise RuntimeError("the stamped copy differs at %s" % entry)
            steps = np.zeros((8192, len(STEPS) + 1), np.uint64)
            blocks = np.zeros((4096, 2), np.uint64)
            lib.repaq_emit_steps(steps.ctypes.data, blocks.ctypes.data, 0)
            steps, blocks = steps.astype(np.int64), blocks.astype(np.int64)
            tiles = steps[steps[:, 0] > 0]
            started = blocks[blocks[:, 0] > 0]
            t0 = started[:, 0].min()
            own = blocks[tiles[:, len(STEPS)], 0]
            marks = np.concatenate([own[:, None], tiles[:, :len(STEPS)]], 1)
            d = np.diff(marks, axis=1) / 1000.0
            row = {name: [float(f(d[:, k])) for f in (
                np.min, np.median, lambda x: np.percentile(x, 90), np.max)]
                for k, (name, _line) in enumerate(STEPS)}
            row["tiles"] = int(tiles.shape[0])
            row["end_us"] = float((started[:, 1].max() - t0) / 1000.0)
            row["last_value_out_us"] = float(
                (tiles[:, 4].max() - t0) / 1000.0)
            res[entry] = row
            print("%s SE steps of a tile (us: min, median, p90, max; %d "
                  "tiles; the last tile's value out at %.2f us, the last "
                  "block's end at %.2f us from the first block's start): "
                  "%s; on %s" % (entry, row["tiles"],
                                 row["last_value_out_us"], row["end_us"],
                                 "; ".join("%s %s" % (
                                     name, " / ".join("%.2f" % x
                                                      for x in row[name]))
                                     for name, _line in STEPS), card),
                  flush=True)
    return res


def tiles_of(entry: str, args, tile: int) -> tuple:
    """(kept, fill) tiles of a call at tiles of `tile` grouped elements:
    the tiles up to the last kept element (the quality stream's up to the
    escapes' end, the N stream's positions below n), and those past it."""
    g = args[0]
    m = g.shape[0]
    if entry == "qualcol_emit":
        kept = min(m, int(args[1].sum()))
    else:
        kept = int((g < args[1]).sum())
    tiles = -(-m // tile)
    kept_tiles = -(-kept // tile)
    return kept_tiles, tiles - kept_tiles


def build_tile(mod, entry: str) -> int:
    """mod's tile for entry (a build whose tile is one for both entries
    takes no entry)."""
    try:
        return int(mod.emit_tile(entry))
    except TypeError:
        return int(mod.emit_tile())


def launcher(mod, entry: str, args):
    """A function of no arguments that runs entry on args as mod's
    wrapper does (mod._emit_launch of its tree)."""
    if entry == "qualcol_emit":
        g, counts, qual, nbins, esc_cap, out_size = args
        return lambda: mod._emit_launch(entry, g, counts, nbins, qual, 0,
                                        esc_cap, out_size)
    g, n, out_size = args
    return lambda: mod._emit_launch(entry, g, None, 0, None, n, 0, out_size)


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
            name = "emit_kernel" if "emit_kernel" in e.name else e.name[:40]
            us[name] = us.get(name, 0.0) + e.time_range.elapsed_us() / calls
    return us


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="another checkout whose emit.cu is timed in turns")
    ap.add_argument("--steps", action="store_true",
                    help="time each step of a tile in a stamped copy")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("profile_emit: torch sees no CUDA device")
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
        info = {"kernels": ptxas_info(trees[label]),
                "tile": {e: build_tile(mod, e)
                         for e in ("qualcol_emit", "positions_emit")}}
        res["builds"][label] = info
        print("%s: tiles of %s grouped elements (quality, N stream); %s" % (
            label, ", ".join(str(t) for t in info["tile"].values()),
            "; ".join("%s %d registers, %d / %d bytes spilled (stores / "
                      "loads), %d bytes of shared memory, %d blocks an SM "
                      "by them" % (name, k["registers"], k["spill_stores"],
                                   k["spill_loads"], k["smem"],
                                   k["blocks_per_sm"])
                      for name, k in info["kernels"].items())), flush=True)
    print("this tree's persistent waves: %d blocks (quality), %d (N stream), "
          "the runtime's occupancy times the SMs" % (
              TK.emit_wave("qualcol_emit"), TK.emit_wave("positions_emit")))
    se, pe = cs.chunk_calls(dev), cs.pe_chunk_calls(dev)
    for entry in ("qualcol_emit", "positions_emit"):
        for tag, call in (("SE", se[entry][0]), ("PE", pe[entry])):
            label = "%s %s (%d grouped, out %d bytes)" % (
                entry, tag, call[0].shape[0], call[-1])
            row = res[label] = {
                "tiles": {name: dict(zip(("kept", "fill"), tiles_of(
                    entry, call, b["tile"][entry])))
                    for name, b in res["builds"].items()},
                "ms": cs.cuda_ms(lambda: getattr(TK, entry)(*call)),
                "kernels_us": kernel_split(lambda: getattr(TK, entry)(*call))}
            print("%s: tiles (kept, fill) %s; %.4f ms; device operations "
                  "(mean us a call) %s; on %s" % (
                      label, "; ".join("%s %d, %d" % (n, t["kept"],
                                                      t["fill"])
                                       for n, t in row["tiles"].items()),
                      row["ms"], "; ".join(
                          "%s %.2f" % kv for kv in row["kernels_us"].items()),
                      card), flush=True)
            if len(mods) == 1:
                continue
            want_out, want_total = cs.emit_plain(entry)(*call)
            runs = {name: launcher(mod, entry, call)
                    for name, mod in mods.items()}
            for name, run in runs.items():
                out, total = run()
                if int(total) != int(want_total) or not torch.equal(
                        out, want_out):
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
    if args.steps:
        res["steps"] = step_times({e: se[e][0] for e in (
            "qualcol_emit", "positions_emit")}, card)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
