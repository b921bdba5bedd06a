#!/usr/bin/env python3
"""Where the run-boundary kernels' time goes, on one NVIDIA GPU, beside the
composition they replaced.

    python3 tools/profile_scan.py [--parent OLD_scan.cu]

Builds repaq_tpu_torch/csrc/scan.cu several ways with the package's nvcc
flags (one nvcc each, in parallel, into a temporary directory):
  as built                  the kernels the package builds: run_offsets
                            with 2 steps of 16 mask bytes a lane (8,192
                            elements a tile), seg_positions with 8 steps of
                            4 elements (8,192 a tile);
  run v1, run v4, seg v4, seg v16
                            -DREPAQ_RUN_VECS / -DREPAQ_SEG_VECS: other tiles
                            (4,096 to 16,384 elements);
  no look-back              -DREPAQ_SCAN_NO_LOOKBACK: every tile starts
                            from the identity (output wrong on purpose);
  parent                    with --parent, an earlier scan.cu whose entry is
                            repaq_scan_i32 (the running maximum and suffix
                            minimum of an int32 row; the earlier design's
                            source: git show
                            162f10f:repaq_tpu_torch/csrc/scan.cu),
                            run inside the torch code that the port ran
                            around it for the same function: the shift,
                            torch.where and arange that build the scans'
                            inputs, both scans with their zero fills, and
                            the arithmetic after them (run_offsets:
                            off_in_run and covered as
                            _classify_stream_positions computed them;
                            seg_positions: cumsum, where, cummax, raw -
                            base - 1 as qualcol_decode_device did).
Every build but "no look-back" is held exact against the plain versions.
Each is timed at the main path's shapes (run_offsets: the SE quality
stream's 2,097,152 elements, a chunk's 11,829,248, the SE coordinates'
(2, 98304) rows; seg_positions: the SE decode's 2,359,296 tokens) two ways:
  one launch     the kernel on status words it leaves zeroed, as the
                 package's wrapper launches it (the parent: its whole
                 composition, zero fills included), a CUDA-event median of
                 15 runs with the L2 flushed (chip_smoke.cuda_ms), as
                 chip_smoke.py times a kernel;
  back to back   48 of those in a row over 8 input sets
                 (chip_smoke.back_to_back_ms): a call's time without the
                 fixed cost of one event-timed launch.
The builds are timed in turns (A B .. B A). A zero fill of status words
alone, as the parent's wrapper made one before each scan, is printed too.
The last line of output is one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "repaq_tpu_torch", "csrc", "scan.cu")
PARENT = "parent"

VARIANTS = {"as built": [], "run v1": ["-DREPAQ_RUN_VECS=1"],
            "run v4": ["-DREPAQ_RUN_VECS=4"], "seg v4": ["-DREPAQ_SEG_VECS=4"],
            "seg v16": ["-DREPAQ_SEG_VECS=16"],
            "no look-back": ["-DREPAQ_SCAN_NO_LOOKBACK"]}
INEXACT = ("no look-back",)
SHAPES = [("run_offsets", (2_097_152,)), ("run_offsets", (11_829_248,)),
          ("run_offsets", (2, 98_304)), ("seg_positions", (2_359_296,))]
SETS, RUNS = 8, 48


def build(tmp: str, parent: str | None) -> dict:
    """name -> loaded library of each variant and of the parent source."""
    from repaq_tpu_torch.ops import _build

    jobs = {name: (SRC, flags) for name, flags in VARIANTS.items()}
    if parent:
        jobs[PARENT] = (parent, [])
    procs = {}
    for i, (name, (src, flags)) in enumerate(jobs.items()):
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
        if name == PARENT:
            lib.repaq_scan_i32.argtypes = [vp, vp, ll, ll, ci, vp, vp]
            lib.repaq_scan_i32.restype = ci
            lib.repaq_scan_status_words.argtypes = [ll, ll]
            lib.repaq_scan_status_words.restype = ll
            continue
        lib.repaq_run_offsets.argtypes = [vp, vp, vp, ll, ll, vp, vp]
        lib.repaq_run_offsets.restype = ci
        lib.repaq_run_offsets_status_words.argtypes = [ll, ll]
        lib.repaq_run_offsets_status_words.restype = ll
        lib.repaq_seg_positions.argtypes = [vp, vp, vp, ll, vp, vp]
        lib.repaq_seg_positions.restype = ci
        lib.repaq_seg_positions_status_words.argtypes = [ll]
        lib.repaq_seg_positions_status_words.restype = ll
    return libs


def _ok(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError("%s failed to launch: %d" % (what, rc))


def launcher(lib, name: str, args: tuple):
    """A function that launches `lib`'s kernel on args, as the package's
    wrapper does (on status words zeroed once, which every launch leaves
    zeroed), and returns its output."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    x = args[0]
    if name == "run_offsets":
        rows = x.shape[0] if x.dim() == 2 else 1
        status = torch.zeros(lib.repaq_run_offsets_status_words(
            rows, x.shape[-1]), dtype=torch.int64, device=x.device)

        def run():
            off = torch.empty(x.shape, dtype=torch.int32, device=x.device)
            to_end = torch.empty_like(off)
            _ok(lib.repaq_run_offsets(x.data_ptr(), off.data_ptr(),
                                      to_end.data_ptr(), rows, x.shape[-1],
                                      status.data_ptr(), stream), name)
            return off, to_end
    else:
        start = args[1]
        status = torch.zeros(lib.repaq_seg_positions_status_words(
            x.shape[0]), dtype=torch.int64, device=x.device)

        def run():
            pos = torch.empty(x.shape, dtype=torch.int32, device=x.device)
            _ok(lib.repaq_seg_positions(x.data_ptr(), start.data_ptr(),
                                        pos.data_ptr(), x.shape[0],
                                        status.data_ptr(), stream), name)
            return pos
    return run


def parent_composition(lib, name: str, args: tuple):
    """A function computing the same outputs as the parent tree's torch
    code did around its two scans (see the module's docstring)."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream

    def scan(x, suffix_min: bool):
        out = torch.empty_like(x)
        rows = x.shape[0] if x.dim() == 2 else 1
        status = torch.zeros(lib.repaq_scan_status_words(rows, x.shape[-1]),
                             dtype=torch.int64, device=x.device)
        _ok(lib.repaq_scan_i32(x.data_ptr(), out.data_ptr(), rows,
                               x.shape[-1], int(suffix_min),
                               status.data_ptr(), stream), "repaq_scan_i32")
        return out

    if name == "run_offsets":
        (adj,) = args

        def run():
            n = adj.shape[-1]
            i = torch.arange(n, dtype=torch.int32, device=adj.device)
            prev = torch.cat([torch.zeros_like(adj[..., :1]), adj[..., :-1]],
                             -1)
            rs_idx = scan(torch.where(adj & ~prev, i, -1), False)
            off_in_run = torch.where(adj, i - rs_idx, 0)
            end_idx = scan(torch.where(~adj, i, n), True)
            run_len = torch.where(adj, end_idx - rs_idx, 0)
            return off_in_run, torch.clamp(run_len - off_in_run, max=32)
    else:
        adv, start = args

        def run():
            raw = torch.cumsum(adv, 0, dtype=torch.int32)
            seg_base = scan(torch.where(start, raw - adv, 0), False)
            return raw - seg_base - 1
    return run


def same(got, want) -> bool:
    import torch

    if isinstance(got, tuple):
        return all(same(g, w) for g, w in zip(got, want))
    return torch.equal(got, want)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an earlier csrc/scan.cu to time in "
                    "the composition it ran in")
    args = ap.parse_args()
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
        libs = build(tmp, args.parent)
        for name, shape in SHAPES:
            rows = shape[0] if len(shape) == 2 else 0
            if name == "run_offsets":
                sets = [(torch.from_numpy(cs.run_case(
                    shape[-1], rows, "random", s)).to(dev),)
                    for s in range(SETS)]
            else:
                sets = [tuple(torch.from_numpy(a).to(dev)
                              for a in cs.seg_case(shape[0], "random", s))
                        for s in range(SETS)]
            want = getattr(TK, name + "_plain")(*sets[0])
            runs = {}
            for v, lib in libs.items():
                make = parent_composition if v == PARENT else launcher
                runs[v] = [make(lib, name, a) for a in sets]
                got = runs[v][0]()
                if v not in INEXACT and not same(got, want):
                    raise RuntimeError("%s %s is not exact at %s"
                                       % (v, name, shape))
            times = {v: [] for v in libs}
            for v in list(libs) + list(reversed(libs)):
                times[v].append({
                    "one_launch": cs.cuda_ms(runs[v][0]),
                    "back_to_back": cs.back_to_back_ms(
                        lambda i, r=runs[v]: r[i](), SETS, RUNS)})
            moved = cs.nbytes(*sets[0]) + cs.nbytes(want)
            bound = 1e3 * moved / cs.HBM_BYTES_PER_S
            key = "%s %s" % (name, shape)
            report[key] = {"bound_ms": bound, "times_ms": times}
            for v, ts in times.items():
                print("%-32s %-13s %s (bound %.4f ms)" % (
                    key, v, "; ".join(
                        ", ".join("%s %.4f" % (k, t[k]) for k in t)
                        for t in ts), bound), flush=True)
            del sets, runs, want
        words = torch.zeros(2, dtype=torch.int64, device=dev)
        report["zero_fill_ms"] = cs.cuda_ms(lambda: words.zero_())
        print("one zero fill of status words alone %.4f ms"
              % report["zero_fill_ms"])
    print(cs.card_line())
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
