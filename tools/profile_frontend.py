#!/usr/bin/env python3
"""Where the pack kernel's and the byte-form frontend's time goes, on one
NVIDIA GPU, beside the parent design.

    python3 tools/profile_frontend.py [--parent OLD_frontend.cu] [--ablate]
                                      [--sass OUT]

Builds repaq_tpu_torch/csrc/frontend.cu several ways with the package's
nvcc flags (one nvcc each, in parallel, into a temporary directory):
  as built              2 groups of 16 bases a thread in flight, one wave
                        of the blocks the runtime's occupancy allows;
  vecs 1, vecs 4, vecs 8
                        -DREPAQ_FRONT_VECS: other groups a thread;
  blocks/SM 1, 2, 4     -DREPAQ_FRONT_BLOCKS_PER_SM: a wave of fewer
                        resident blocks, the grid striding past it;
  copy, loads only      with --ablate, -DREPAQ_FRONT_ABLATE=1 and 2: the
                        classification replaced by a plain copy of the
                        loaded bytes (memory alone), and the loads alone
                        (both wrong on purpose);
  parent                with --parent, an earlier frontend.cu (the parent
                        tree's: git archive into .parent/), run as its
                        wrappers ran it: pack_bases a launch of its
                        pack_kernel; encode_frontend_bytes a launch of its
                        frontend_kernel followed by the torch passes that
                        split the meta bytes (meta >= 0x80, meta & 0x7F,
                        .to(torch.int32)).
Every build but the ablations is held exact against the plain versions.
pack_bases is timed at 12,000,003 bases and encode_frontend_bytes at the
PE chunk's 14,745,600, each four ways: one launch (a CUDA-event median of
15 runs after a flush that dirties the L2, chip_smoke.cuda_ms, as
chip_smoke.py times a kernel); back to back (48 launches over 8 input
sets, chip_smoke.back_to_back_ms); one launch after a flush that leaves no
dirty line (cuda_ms(clean=True)); and one launch at 16 bases (the fixed
cost of an event-timed launch). The builds are timed in turns
(A B .. B A). Beside the byte form, torch's fill_ of its output bytes
(one launch and back to back) and a copy of its input bytes give what
memory alone allows each half of its traffic. ptxas' register and shared-memory report of the build as
built is printed; with --sass, the SASS of it (and of the parent) is
written to OUT and each kernel's instruction count printed. The last line
of output is one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "repaq_tpu_torch", "csrc", "frontend.cu")
PARENT = "parent"

VARIANTS = {"as built": [], "vecs 1": ["-DREPAQ_FRONT_VECS=1"],
            "vecs 4": ["-DREPAQ_FRONT_VECS=4"],
            "vecs 8": ["-DREPAQ_FRONT_VECS=8"],
            "blocks/SM 1": ["-DREPAQ_FRONT_BLOCKS_PER_SM=1"],
            "blocks/SM 2": ["-DREPAQ_FRONT_BLOCKS_PER_SM=2"],
            "blocks/SM 4": ["-DREPAQ_FRONT_BLOCKS_PER_SM=4"]}
ABLATIONS = {"copy": ["-DREPAQ_FRONT_ABLATE=1"],
             "loads only": ["-DREPAQ_FRONT_ABLATE=2"]}
PACK_BASES = 12_000_003
SETS, RUNS = 8, 48


def build(tmp: str, jobs: dict) -> dict:
    """name -> (loaded library, path, ptxas' report) of each build in
    jobs (name -> (source, flags))."""
    from repaq_tpu_torch.ops import _build

    procs = {}
    for i, (name, (src, flags)) in enumerate(jobs.items()):
        so = os.path.join(tmp, "v%d.so" % i)
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-Xptxas", "-v",
             "-shared", "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    libs = {}
    for name, (so, p) in procs.items():
        out = p.communicate()[0].decode(errors="replace")
        if p.returncode:
            raise RuntimeError("nvcc failed on %r:\n%s" % (name, out))
        lib = ctypes.CDLL(so)
        lib.repaq_pack_bases.argtypes = [vp, vp, ll, vp]
        lib.repaq_pack_bases.restype = ci
        lib.repaq_encode_frontend.argtypes = [vp, vp, vp, ci, ci, vp, vp, ll,
                                              vp]
        lib.repaq_encode_frontend.restype = ci
        if name != PARENT:
            lib.repaq_encode_frontend_bytes.argtypes = [vp, vp, vp, ci, ci,
                                                        vp, vp, vp, ll, vp]
            lib.repaq_encode_frontend_bytes.restype = ci
            for f in ("repaq_pack_wave_bases",
                      "repaq_frontend_bytes_wave_bases"):
                getattr(lib, f).argtypes = []
                getattr(lib, f).restype = ll
        libs[name] = (lib, so, out)
    return libs


def _ok(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError("%s failed to launch: %d" % (what, rc))


def pack_launcher(lib, seq):
    """pack_bases as the package's wrapper runs it, with `lib`'s kernel."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream

    def run():
        out = torch.empty((seq.shape[0] + 3) // 4, dtype=torch.uint8,
                          device=seq.device)
        _ok(lib.repaq_pack_bases(seq.data_ptr(), out.data_ptr(),
                                 seq.shape[0], stream), "pack_bases")
        return out
    return run


def bytes_launcher(lib, parent: bool, seq, qual, bins, major):
    """encode_frontend_bytes as the package's wrapper runs it with `lib`'s
    kernel, or as the parent's ran it: the meta kernel, then the split."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    n, dev = seq.shape[0], seq.device

    def run():
        packed = torch.empty((n + 3) // 4, dtype=torch.uint8, device=dev)
        if parent:
            meta = torch.empty(n, dtype=torch.uint8, device=dev)
            _ok(lib.repaq_encode_frontend(
                seq.data_ptr(), qual.data_ptr(), bins.data_ptr(),
                bins.shape[0], major, packed.data_ptr(), meta.data_ptr(), n,
                stream), "encode_frontend")
            return packed, meta >= 0x80, (meta & 0x7F).to(torch.int32)
        nmask = torch.empty(n, dtype=torch.bool, device=dev)
        bid = torch.empty(n, dtype=torch.int32, device=dev)
        _ok(lib.repaq_encode_frontend_bytes(
            seq.data_ptr(), qual.data_ptr(), bins.data_ptr(), bins.shape[0],
            major, packed.data_ptr(), nmask.data_ptr(), bid.data_ptr(), n,
            stream), "encode_frontend_bytes")
        return packed, nmask, bid
    return run


def sass_counts(so: str, out) -> dict:
    """kernel -> SASS instruction count of the library at `so`, its SASS
    appended to the open file `out`."""
    from repaq_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    out.write(text)
    counts, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and re.match(r"\s*/\*[0-9a-f]{4}\*/", line):
            counts[name] += 1
    return counts


def inputs(dev, n: int, seed: int):
    """Seeded seq (ACGT, 0.1% N) and NovaSeq quals of n bases."""
    import numpy as np
    import torch

    import chip_smoke as cs

    rng = np.random.default_rng(seed)
    seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n)
    seq[rng.random(n) < 0.001] = ord("N")
    qual = rng.choice(np.frombuffer(cs.NOVA_QUALS, np.uint8), size=n,
                      p=cs.NOVA_P)
    return torch.from_numpy(seq).to(dev), torch.from_numpy(qual).to(dev)


def same(got, want) -> bool:
    import torch

    if isinstance(got, tuple):
        return all(g.dtype == w.dtype and torch.equal(g, w)
                   for g, w in zip(got, want))
    return torch.equal(got, want)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an earlier csrc/frontend.cu to time "
                    "as its wrappers ran it")
    ap.add_argument("--ablate", action="store_true",
                    help="also the copy and loads-only builds")
    ap.add_argument("--sass", help="write the SASS here")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("profile_frontend: torch sees no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repaq_tpu_torch.ops import kernels as TK

    dev = torch.device("cuda:0")
    jobs = {name: (SRC, flags) for name, flags in VARIANTS.items()}
    if args.ablate:
        jobs.update({name: (SRC, flags) for name, flags in ABLATIONS.items()})
    if args.parent:
        jobs[PARENT] = (args.parent, [])
    bins = torch.tensor(list(b"#,:"), dtype=torch.uint8, device=dev)
    major = ord("F")
    report = {"card": cs.card_line()}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp, jobs)
        print("ptxas, as built:\n" + "\n".join(
            line for line in libs["as built"][2].splitlines()
            if "registers" in line or "Compiling entry" in line))
        for v, (lib, _, _) in libs.items():
            if v != PARENT:
                print("%-14s one wave: pack %d bases, byte form %d bases"
                      % (v, lib.repaq_pack_wave_bases(),
                         lib.repaq_frontend_bytes_wave_bases()))
        if args.sass:
            with open(args.sass, "w") as f:
                report["sass_instructions"] = {
                    v: sass_counts(libs[v][1], f)
                    for v in ("as built", PARENT) if v in libs}
            print("SASS instructions: %s" % report["sass_instructions"])
        for kernel, n in (("pack_bases", PACK_BASES),
                          ("encode_frontend_bytes", cs.PE_BASES)):
            sets = [inputs(dev, n, s) for s in range(SETS)]
            tiny = inputs(dev, 16, SETS)

            def make(lib, v, data):
                if kernel == "pack_bases":
                    return pack_launcher(lib, data[0])
                return bytes_launcher(lib, v == PARENT, *data, bins, major)
            plain = getattr(TK, kernel + "_plain")
            want = plain(*(sets[0][:1] if kernel == "pack_bases" else
                           (*sets[0], bins, major)))
            runs, small = {}, {}
            for v, (lib, _, _) in libs.items():
                runs[v] = [make(lib, v, d) for d in sets]
                small[v] = make(lib, v, tiny)
                if v not in ABLATIONS and not same(runs[v][0](), want):
                    raise RuntimeError("%s %s is not exact" % (v, kernel))
            times = {v: [] for v in libs}
            for v in list(libs) + list(reversed(libs)):
                times[v].append({
                    "one_launch": cs.cuda_ms(runs[v][0]),
                    "back_to_back": cs.back_to_back_ms(
                        lambda i, r=runs[v]: r[i](), SETS, RUNS),
                    "clean_flush": cs.cuda_ms(runs[v][0], clean=True),
                    "16_bases": cs.cuda_ms(small[v])})
            moved = (n + (n + 3) // 4 if kernel == "pack_bases"
                     else 7 * n + (n + 3) // 4)
            bound = 1e3 * moved / cs.HBM_BYTES_PER_S
            key = "%s at %d bases" % (kernel, n)
            report[key] = {"bound_ms": bound, "times_ms": times}
            for v, ts in times.items():
                print("%-40s %-14s %s (bound %.4f ms)" % (
                    key, v, "; ".join(
                        ", ".join("%s %.4f" % (k, t[k]) for k in t)
                        for t in ts), bound), flush=True)
            del sets, runs, want
            if kernel == "encode_frontend_bytes":
                # the byte form's 77 MB of outputs written alone by torch's
                # fill_, and its 29 MB of inputs copied: what memory alone
                # allows the two halves of its traffic
                out = torch.empty(moved - 2 * n, dtype=torch.uint8,
                                  device=dev)
                src = torch.empty(2 * n, dtype=torch.uint8, device=dev)
                dst = torch.empty_like(src)
                report["floors_ms"] = {
                    "fill_outputs": cs.cuda_ms(lambda: out.fill_(1)),
                    "fill_outputs_back_to_back": cs.back_to_back_ms(
                        lambda i: out.fill_(i), SETS, RUNS),
                    "copy_inputs": cs.cuda_ms(lambda: dst.copy_(src))}
                print("memory floors of the byte form, ms: %s"
                      % report["floors_ms"], flush=True)
                del out, src, dst
    print(report["card"])
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
