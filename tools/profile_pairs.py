#!/usr/bin/env python3
"""What the PE pair kernels (``kernels.pe_encode_pairs``,
``kernels.pe_decode_rows``, repaq_tpu_torch/csrc/overlap.cu) cost on one
NVIDIA GPU, at one real PE chunk's calls: 40,000 pairs of 150 bp of
chip_smoke's phase 5 corpus (b_cap 98,304), compressed and decompressed
through repaq_tpu_torch.cli.main with the calls recorded
(chip_smoke.pe_chunk_calls).

    python3 tools/profile_pairs.py [--tree DIR ...]

For each entry: its CUDA-event time (median of 15, the L2 flushed by
writes, chip_smoke.cuda_ms; the encode, which works in place, gets its
grids back untimed before each call), after a clean flush (reads) and back
to back, its device kernel's time under torch.profiler, and the parent's
composition in turns (chip_smoke.parent_pe_encode, parent_pe_decode:
parent, entry, entry, parent). With ``--tree`` it builds this checkout's
overlap.cu and each DIR's repaq_tpu_torch/csrc/overlap.cu (one nvcc each,
in parallel, into a temporary directory, ``-Xptxas -v`` printed), holds
each build exact against the plain versions and times them in turns
(A B ... B A), each with its device kernels' time: an earlier design, or
a variant of this one, at the same real calls.
Every time is printed beside the card's name and power limit. The last
line of output is one JSON object.
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
SRC = os.path.join(ROOT, "repaq_tpu_torch", "csrc", "overlap.cu")


def kernel_us(fn, runs: int = 15) -> dict:
    """{kernel name: median device us} of fn()'s pair kernels over `runs`
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
            hit = re.search(r"pe_(encode|decode)(_direct)?_kernel", e.name)
            if e.device_type == DeviceType.CUDA and hit:
                times.setdefault(hit.group(0), []).append(
                    e.time_range.elapsed_us())
    return {k: statistics.median(v) for k, v in times.items()}


def build(tmp: str, sources: dict) -> dict:
    """name -> (loaded library, ptxas' report) of each source's build."""
    from repaq_tpu_torch.ops import _build

    procs = {}
    for i, (name, src) in enumerate(sources.items()):
        so = os.path.join(tmp, "v%d.so" % i)
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
             "-shared", "-o", so, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    libs = {}
    for name, (so, p) in procs.items():
        out = p.communicate()[0].decode(errors="replace")
        if p.returncode:
            raise RuntimeError("nvcc failed on %r:\n%s" % (name, out))
        lib = ctypes.CDLL(so)
        lib.repaq_pe_encode_pairs.argtypes = [vp, vp, ci, ll, ll, ci, ci, vp,
                                              vp]
        lib.repaq_pe_decode_rows.argtypes = [vp, ci, vp, vp, ll, ci, ci, vp,
                                             vp]
        libs[name] = (lib, out.strip())
    return libs


def encode_launcher(lib, grids, n_pairs, shift, search):
    """A function that launches lib's pe_encode_pairs on grids (in place)
    as the package's wrapper does and returns ov."""
    import torch

    seq, qual = grids
    rows, L = seq.shape
    stream = torch.cuda.current_stream(seq.device).cuda_stream

    def run():
        ov = torch.empty(rows // 2, dtype=torch.int32, device=seq.device)
        rc = lib.repaq_pe_encode_pairs(seq.data_ptr(), qual.data_ptr(), L,
                                       rows // 2, n_pairs, shift, int(search),
                                       ov.data_ptr(), stream)
        if rc:
            raise RuntimeError("pe_encode_pairs failed to launch: %d" % rc)
        return ov
    return run


def decode_launcher(lib, stored, qual, tables, L, nbq):
    """A function that launches lib's pe_decode_rows as the package's
    wrapper does and returns its payload."""
    import torch

    rows = qual.shape[0] // L
    stream = torch.cuda.current_stream(qual.device).cuda_stream

    def run():
        out = torch.empty(2 * qual.shape[0], dtype=torch.uint8,
                          device=qual.device)
        rc = lib.repaq_pe_decode_rows(
            stored.data_ptr(), stored.shape[0], qual.data_ptr(),
            None if tables is None else tables.data_ptr(), rows, L,
            -1 if nbq is None else nbq, out.data_ptr(), stream)
        if rc:
            raise RuntimeError("pe_decode_rows failed to launch: %d" % rc)
        return out
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="another checkout whose overlap.cu is timed in "
                    "turns with this one's (repeatable)")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("profile_pairs: torch sees no CUDA device")
        return 2
    import chip_smoke as cs
    from repaq_tpu_torch.ops import kernels as TK

    dev = torch.device("cuda:0")
    card = cs.card_line()
    rec = cs.pe_chunk_calls(dev)
    seq_mat, qual_mat, n_pairs, shift, search = rec["pe_encode_pairs"]
    stored, qual, tables, L, nbq = rec["pe_decode_rows"]
    grids = (seq_mat.clone(), qual_mat.clone())

    def restore():
        grids[0].copy_(seq_mat)
        grids[1].copy_(qual_mat)

    def enc():
        return TK.pe_encode_pairs(*grids, n_pairs, shift, search)

    def dec():
        return TK.pe_decode_rows(stored, qual, tables, L, nbq)

    res = {"card": card, "tile": TK.pe_pair_tile(L)}
    print("card: %s; PE chunk: %d of %d pairs of %d bytes, tile %d pairs"
          % (card, n_pairs, seq_mat.shape[0] // 2, L, res["tile"]),
          flush=True)
    parents = {"pe_encode_pairs": cs.parent_pe_encode(
        seq_mat, qual_mat, n_pairs, shift, search),
        "pe_decode_rows": cs.parent_pe_decode(
            stored.clone(), qual.clone(), tables, L, nbq)}
    for name, fn, setup in (("pe_encode_pairs", enc, restore),
                            ("pe_decode_rows", dec, None)):
        row = {"ms": cs.cuda_ms(fn, setup=setup),
               "clean_ms": cs.cuda_ms(fn, clean=True, setup=setup),
               "back_to_back_ms": cs.back_to_back_ms(lambda _i: fn(), 8),
               "kernels_us": kernel_us(fn),
               "in_turns_ms": cs.in_turns(
                   [("parent", parents[name]), (name, fn)], name,
                   setups={name: setup})}
        res[name] = row
        print("%s: %.4f ms (clean flush %.4f, back to back %.4f); kernels "
              "%s us; on %s" % (name, row["ms"], row["clean_ms"],
                                row["back_to_back_ms"],
                                ", ".join("%s %.2f" % kv for kv in
                                          row["kernels_us"].items()), card),
              flush=True)
    if args.tree:
        res["trees"] = {}
        sources = {"this tree": SRC}
        for tree in args.tree:
            sources[os.path.basename(os.path.normpath(tree))] = os.path.join(
                os.path.abspath(tree), "repaq_tpu_torch", "csrc",
                "overlap.cu")
        with tempfile.TemporaryDirectory() as tmp:
            libs = build(tmp, sources)
            for v, (lib, ptxas) in libs.items():
                print("ptxas %s (%s):\n%s" % (v, sources[v], ptxas),
                      flush=True)
            want_ov = TK.pe_encode_pairs_plain(*(g.clone() for g in (
                seq_mat, qual_mat)), n_pairs, shift, search)
            want_rows = TK.pe_decode_rows_plain(stored, qual, tables, L, nbq)
            for label, make, setup, want in (
                    ("pe_encode_pairs", lambda lib: encode_launcher(
                        lib, grids, n_pairs, shift, search), restore,
                     want_ov),
                    ("pe_decode_rows", lambda lib: decode_launcher(
                        lib, stored, qual, tables, L, nbq), None,
                     want_rows)):
                runs = {}
                for v, (lib, _p) in libs.items():
                    runs[v] = make(lib)
                    if setup:
                        setup()
                    got = runs[v]()
                    torch.cuda.synchronize()
                    if cs.max_abs_err(got, want):
                        raise RuntimeError("%s is not exact for %s"
                                           % (v, label))
                times = {v: [] for v in libs}
                for v in list(libs) + list(reversed(libs)):
                    times[v].append(cs.cuda_ms(runs[v], setup=setup))
                split = {v: kernel_us(runs[v]) for v in libs}
                res["trees"][label] = {v: {"ms": times[v],
                                            "kernels_us": split[v]}
                                        for v in libs}
                for v, ts in times.items():
                    print("tree %-16s %-14s %s ms; kernels %s us; on %s" % (
                        label, v, ", ".join("%.4f" % t for t in ts),
                        ", ".join("%s %.2f" % kv
                                  for kv in split[v].items()), card),
                        flush=True)
            restore()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
