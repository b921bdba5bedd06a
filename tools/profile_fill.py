#!/usr/bin/env python3
"""What the decode's run writes cost on one NVIDIA GPU: the scatters that
``kernels.fill_runs`` replaced, and why they cost what they did; and, with
``--runs``, the output-stationary entries that took the main path's two
largest run writes (``kernels.fill_sorted_runs``, ``concat_row_spans``).

    python3 tools/profile_fill.py [--kernel [--tree DIR]]
    python3 tools/profile_fill.py --runs [--ablate]

At one SE decode chunk's shapes (chip_smoke.FILL_CHUNK: 12,582,912
positions, a token cap of 2,359,296, 1,680,349 tokens, 1,689,953
positions, the run cap 786,432 that DeviceEngine._decode_caps gives it),
each a CUDA-event median of 15 runs with the L2 flushed
(chip_smoke.cuda_ms):
  dump sector   one index_put_ of the run grid's entries (min(run cap,
                4-token groups) x 4 x 31 = 73,138,176) into a (length + 1,)
                buffer, every entry aimed at its last byte, as the masked
                lanes of the grid were;
  distinct      the same number of entries aimed at distinct bytes, in
                order (index i to byte i) and in a random permutation;
  grid mix      the grid's real mix: positions - tokens entries at their
                run bytes, the rest at the dump byte;
  tokens        one index_put_ a token (the token cap's entries, the
                masked ones at the dump byte), as the parent's token write;
  parent        the parent's whole composition (chip_smoke.parent_qual_fill:
                the token write, the group compaction, the grid and its
                index_put_);
  fill_runs     the kernel on the same writes (with --kernel, on a tree
                that has it), called as the decode calls it (no keep: the
                masked tail has count 0), exact against the parent's
                composition, in turns with it.
``--tree DIR`` takes the kernel from the package of another checkout (for
example an earlier design unpacked by ``git archive`` into an ignored
directory) and times it with this script, so two designs can be read in
turns, one process each.

``--runs``: at one real SE decode chunk's quality call and one real PE
encode chunk's elision, recorded through repaq_tpu_torch.cli.main
(chip_smoke.chunk_calls, chip_smoke.pe_chunk_calls), each entry's
CUDA-event time (flushed by writes, by reads, and back to back), its two
device kernels' times under torch.profiler (the order check and the
tiles), and the parent's composition in turns (chip_smoke.parent_qual_write;
the elision as a whole, chip_smoke.parent_elide against _elide). With
``--ablate`` it builds repaq_tpu_torch/csrc/fill.cu with its switches (one
nvcc each, in parallel, into a temporary directory), holds each build
exact against the plain versions and times them in turns (A B ... B A)
at both calls:
  as built       the quality write's tiles find their entries in the table
                 the check writes, the elision's by two warps' 32-way
                 probes; 16,384-byte tiles;
  warp search    -DREPAQ_RUNS_SEARCH=1: both search (the check writes no
                 table);
  tiles 8 KB     -DREPAQ_RUNS_TILE=8192;
  prologue only  -DREPAQ_RUNS_CUT=1: a tile returns once it has its
                 entries' ranges (nothing written);
  no runs        -DREPAQ_RUNS_CUT=2: a tile writes its background
                 (elision: stages its rows and bytes, copies nothing).
The two cut builds are timed, not held exact.
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


SRC = os.path.join(ROOT, "repaq_tpu_torch", "csrc", "fill.cu")
# name -> nvcc flags of each build --ablate times; the cut builds'
# output is not whole, so only the others are held exact
VARIANTS = {"as built": [], "warp search": ["-DREPAQ_RUNS_SEARCH=1"],
            "tiles 8 KB": ["-DREPAQ_RUNS_TILE=8192"],
            "prologue only": ["-DREPAQ_RUNS_CUT=1"],
            "no runs": ["-DREPAQ_RUNS_CUT=2"]}
CUT = ("prologue only", "no runs")


def kernel_split(fn, runs: int = 15) -> dict:
    """{kernel name: median device us} of fn()'s sorted-run kernels over
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
            hit = re.search(r"runs_(check|tile)_kernel(<\w+>)?", e.name)
            if e.device_type == DeviceType.CUDA and hit:
                times.setdefault(hit.group(0), []).append(
                    e.time_range.elapsed_us())
    return {k: statistics.median(v) for k, v in times.items()}


def build(tmp: str) -> dict:
    """name -> loaded library of each VARIANTS build of fill.cu."""
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
        lib.repaq_sorted_runs_scratch_words.argtypes = [ll, ci, ll]
        lib.repaq_sorted_runs_scratch_words.restype = ll
        lib.repaq_fill_sorted_runs.argtypes = [vp, ll, ci, vp, vp, ll, vp, vp,
                                               ci, vp, vp]
        lib.repaq_concat_row_spans.argtypes = [vp, ll, ci, vp, ll, ll, vp, vp,
                                               vp, ll, vp, vp]
    return libs


def runs_launcher(lib, length, bg, start, count, seg_off, seg_value):
    """A function that launches `lib`'s fill_sorted_runs as the package's
    wrapper does and returns its output."""
    import torch

    dev, n, nseg = start.device, start.shape[0], seg_value.shape[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    words = lib.repaq_sorted_runs_scratch_words(n, nseg, length)

    def run():
        out = torch.empty(length, dtype=torch.uint8, device=dev)
        scratch = torch.empty(words, dtype=torch.int32, device=dev)
        rc = lib.repaq_fill_sorted_runs(
            out.data_ptr(), length, bg, start.data_ptr(), count.data_ptr(),
            n, seg_off.data_ptr(), seg_value.data_ptr(), nseg,
            scratch.data_ptr(), stream)
        if rc:
            raise RuntimeError("fill_sorted_runs failed to launch: %d" % rc)
        return out
    return run


def concat_launcher(lib, src, src_start, span, dest_off, length, bg):
    """A function that launches `lib`'s concat_row_spans as the package's
    wrapper does and returns its output."""
    import torch

    dev, rows = src.device, src.shape[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    words = lib.repaq_sorted_runs_scratch_words(rows, 1, length)

    def run():
        out = torch.empty(length, dtype=torch.uint8, device=dev)
        scratch = torch.empty(words, dtype=torch.int32, device=dev)
        rc = lib.repaq_concat_row_spans(
            out.data_ptr(), length, bg, src.data_ptr(), src.stride(0),
            src.shape[1], src_start.data_ptr(), span.data_ptr(),
            dest_off.data_ptr(), rows, scratch.data_ptr(), stream)
        if rc:
            raise RuntimeError("concat_row_spans failed to launch: %d" % rc)
        return out
    return run


def runs_main(cs, ablate: bool) -> dict:
    import torch

    from repaq_tpu_torch.codec import device_engine as DE
    from repaq_tpu_torch.ops import kernels as TK

    dev = torch.device("cuda:0")
    qargs = cs.chunk_calls(dev)["fill_sorted_runs"][0]
    rec = cs.pe_chunk_calls(dev)
    cargs = rec["concat_row_spans"]
    calls = [("quality write", qargs, TK.fill_sorted_runs,
              TK.fill_sorted_runs_plain, runs_launcher,
              ("parent", cs.parent_qual_write(*qargs))),
             ("elision", cargs, TK.concat_row_spans,
              TK.concat_row_spans_plain, concat_launcher,
              ("parent _elide", lambda: cs.parent_elide(*rec["elide"])))]
    res = {"card": cs.card_line()}
    print("card: %s" % res["card"], flush=True)
    for label, args, kern, _plain, _launcher, (pname, parent) in calls:
        def call(kern=kern, args=args):
            return kern(*args)

        row = {"ms": cs.cuda_ms(call), "clean_ms": cs.cuda_ms(call,
                                                               clean=True),
               "back_to_back_ms": cs.back_to_back_ms(lambda _i: call(), 8),
               "kernels_us": kernel_split(call)}
        fns = [(pname, parent), (label, call)]
        if label == "elision":
            fns[1] = ("_elide", lambda: DE._elide(*rec["elide"]))
        row["in_turns_ms"] = cs.in_turns(fns, label)
        res[label] = row
        print("%s: %.4f ms (clean flush %.4f, back to back %.4f); kernels %s "
              "us" % (label, row["ms"], row["clean_ms"],
                      row["back_to_back_ms"],
                      ", ".join("%s %.2f" % kv
                                for kv in row["kernels_us"].items())),
              flush=True)
    if ablate:
        res["ablate"] = {}
        with tempfile.TemporaryDirectory() as tmp:
            libs = build(tmp)
            for label, args, _kern, plain, launcher, _p in calls:
                want = plain(*args)
                runs = {}
                for v, lib in libs.items():
                    runs[v] = launcher(lib, *args)
                    got = runs[v]()
                    torch.cuda.synchronize()
                    if v not in CUT and cs.max_abs_err(got, want):
                        raise RuntimeError("%s is not exact at the %s"
                                           % (v, label))
                times = {v: [] for v in libs}
                for v in list(libs) + list(reversed(libs)):
                    times[v].append(cs.cuda_ms(runs[v]))
                split = {v: kernel_split(runs[v]) for v in libs}
                res["ablate"][label] = {v: {"ms": times[v],
                                            "kernels_us": split[v]}
                                        for v in libs}
                for v, ts in times.items():
                    print("ablate %-14s %-12s %s ms; kernels %s us" % (
                        label, v, ", ".join("%.4f" % t for t in ts),
                        ", ".join("%s %.2f" % kv
                                  for kv in split[v].items())), flush=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", action="store_true",
                    help="also time kernels.fill_runs in turns with the "
                         "parent's composition")
    ap.add_argument("--tree", default=ROOT,
                    help="checkout whose repaq_tpu_torch --kernel times")
    ap.add_argument("--runs", action="store_true",
                    help="time fill_sorted_runs and concat_row_spans at "
                         "one real chunk's calls")
    ap.add_argument("--ablate", action="store_true",
                    help="with --runs, time builds of fill.cu with its "
                         "switches set")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("profile_fill: torch sees no CUDA device")
        return 2
    import chip_smoke as cs

    if args.runs:
        print(json.dumps(runs_main(cs, args.ablate)))
        return 0

    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)  # chip_smoke imports the package lazily
    dev = torch.device("cuda:0")
    c = cs.FILL_CHUNK
    length = c["length"]
    out, start, count, value, keep = cs.fill_chunk_inputs(dev)
    ng = (start.shape[0] + 3) // 4
    grid = min(c["run_cap"], ng) * 4 * 31  # the sort-slice keeps <= ng
    res = {"card": cs.card_line(), "grid_entries": grid, "tree": tree}
    print("card: %s; grid entries %d; tree %s" % (res["card"], grid, tree))

    qual = torch.zeros(length + 1, dtype=torch.uint8, device=dev)
    big = torch.zeros(grid + 1, dtype=torch.uint8, device=dev)
    vals = torch.full((grid,), 58, dtype=torch.uint8, device=dev)
    g = torch.Generator(device=dev).manual_seed(73)
    runs = c["positions"] - c["tokens"]
    mix = torch.full((grid,), length, dtype=torch.long, device=dev)
    mix[torch.randperm(grid, device=dev, generator=g)[:runs]] = \
        torch.randperm(length, device=dev, generator=g)[:runs]
    cases = {
        "dump sector": (qual, torch.full((grid,), length, dtype=torch.long,
                                         device=dev)),
        "distinct, in order": (big, torch.arange(grid, device=dev)),
        "distinct, permuted": (big, torch.randperm(grid, device=dev,
                                                   generator=g)),
        "grid mix": (qual, mix),
    }
    for name, (dst, idx) in cases.items():
        ms = cs.cuda_ms(lambda: dst.index_put_((idx,), vals))
        res[name] = ms
        print("index_put_ %-20s %d entries: %.4f ms (%.2f G entries/s)"
              % (name, grid, ms, grid / ms / 1e6))
        del idx
    del cases, mix, big, vals
    tok_idx = torch.where(keep, start, length).long()
    res["tokens"] = cs.cuda_ms(lambda: qual.index_put_((tok_idx,), value))
    print("index_put_ tokens %d entries (%d masked): %.4f ms"
          % (tok_idx.shape[0], int((~keep).sum()), res["tokens"]))

    def parent():
        return cs.parent_qual_fill(out, start, count, value, keep,
                                   c["run_cap"])

    turns = [("parent", parent)]
    if args.kernel:
        from repaq_tpu_torch.ops import kernels as TK

        def kernel():
            q = out.clone()
            TK.fill_runs(q, start, count, value)
            return q

        err = cs.max_abs_err(kernel(), parent())
        if err:
            raise SystemExit("fill_runs differs from the parent's "
                             "composition (max abs err %d)" % err)
        turns = [("parent", parent), ("fill_runs", kernel),
                 ("fill_runs", kernel), ("parent", parent)]
    for name, fn in turns:
        ms = cs.cuda_ms(fn)
        res.setdefault(name, []).append(ms)
        print("%-10s %.4f ms (the chunk's quality writes, a copy of the "
              "output included)" % (name, ms))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
