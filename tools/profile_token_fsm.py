#!/usr/bin/env python3
"""Where the token FSM kernel's time goes, on one NVIDIA GPU, and an
earlier design of it beside the current one.

    python3 tools/profile_token_fsm.py [OLD_token_fsm.cu]

Builds repaq_tpu_torch/csrc/token_fsm.cu three ways with the package's
nvcc flags (one nvcc each, in parallel, into a temporary directory) and
times each at chip_smoke.py's phase-2 shape (11,829,248 stream bytes) and
at the SE corpus's quality buffer (2,359,296), uint8 and int32 lengths:
  as built                  the kernel the package builds (held exact);
  no look-back              -DREPAQ_FSM_NO_LOOKBACK: every tile enters in
                            state 0 (output wrong on purpose);
  no look-back, no ticket   and -DREPAQ_FSM_NO_TICKET: the tile index is
                            blockIdx.x, not the atomic counter's.
OLD_token_fsm.cu, when given, is a source of the three-pass design that
came before (``git show <commit>:repaq_tpu_torch/csrc/token_fsm.cu``),
with entry points repaq_token_start_mask(lens int32, force, n, scratch,
out, stream) and repaq_token_fsm_scratch(n); it is held exact and timed
with int32 lengths, its only type.

The builds are timed in turns, each twice (A B C .. C B A), every time a
CUDA-event median of 15 runs with the L2 flushed (chip_smoke.cuda_ms). A
time of the current design includes the zeroing of its status words, as
the decode pays it; the zeroing alone is printed as the floor of any
one-launch time here. The last line of output is one JSON object.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "repaq_tpu_torch", "csrc", "token_fsm.cu")
VARIANTS = {"as built": [], "no look-back": ["-DREPAQ_FSM_NO_LOOKBACK"],
            "no look-back, no ticket": ["-DREPAQ_FSM_NO_LOOKBACK",
                                        "-DREPAQ_FSM_NO_TICKET"]}
OLD = "old three-pass"
EXACT = ("as built", OLD)


def build(tmp: str, old_src: str | None) -> dict:
    """name -> loaded library of each variant, and of the old source."""
    from repaq_tpu_torch.ops import _build

    jobs = {name: (SRC, flags) for name, flags in VARIANTS.items()}
    if old_src:
        jobs[OLD] = (old_src, [])
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
        lib.repaq_token_start_mask.restype = ci
        if name == OLD:
            lib.repaq_token_start_mask.argtypes = [vp, vp, ll, vp, vp, vp]
            lib.repaq_token_fsm_scratch.argtypes = [ll]
            lib.repaq_token_fsm_scratch.restype = ll
        else:
            lib.repaq_token_start_mask.argtypes = [vp, ci, vp, ll, vp, vp, vp]
            lib.repaq_token_fsm_status_words.argtypes = [ll]
            lib.repaq_token_fsm_status_words.restype = ll
    return libs


def launcher(name: str, lib, lens, force):
    """A function that launches `lib`'s kernel on (lens, force) and
    returns its output."""
    import torch

    n, dev = lens.shape[0], lens.device
    out = torch.empty(n, dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    if name == OLD:
        scratch = torch.empty(lib.repaq_token_fsm_scratch(n),
                              dtype=torch.uint8, device=dev)
        status = None
        args = (lens.data_ptr(), force.data_ptr(), n, scratch.data_ptr(),
                out.data_ptr(), stream)
    else:
        status = torch.empty(lib.repaq_token_fsm_status_words(n),
                             dtype=torch.int32, device=dev)
        args = (lens.data_ptr(), lens.element_size(), force.data_ptr(), n,
                status.data_ptr(), out.data_ptr(), stream)

    def run():
        if status is not None:
            status.zero_()
        rc = lib.repaq_token_start_mask(*args)
        if rc:
            raise RuntimeError("%s failed to launch: %d" % (name, rc))
        return out

    return run


def main() -> int:
    if len(sys.argv) > 2:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("profile_token_fsm: torch sees no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repaq_tpu_torch.ops import kernels as TK

    dev = torch.device("cuda:0")
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp, sys.argv[1] if len(sys.argv) == 2 else None)
        for n in (cs.B_READS * cs.READ_LEN, 2_359_296):
            lens8, force = cs.fsm_inputs(dev, n, torch.uint8, 175)
            want = TK.token_start_mask_plain(lens8, force)
            for dtype in (torch.uint8, torch.int32):
                lens = lens8.to(dtype)
                runs = {name: launcher(name, lib, lens, force)
                        for name, lib in libs.items()
                        if name != OLD or dtype == torch.int32}
                for name, run in runs.items():
                    exact = torch.equal(run(), want)
                    if name in EXACT and not exact:
                        raise RuntimeError("%s is not exact" % name)
                times = {name: [] for name in runs}
                for name in list(runs) + list(reversed(runs)):
                    times[name].append(cs.cuda_ms(runs[name]))
                bound = 1e3 * cs.nbytes(lens, force, want) / cs.HBM_BYTES_PER_S
                key = "n=%d %s" % (n, str(dtype)[6:])
                report[key] = {"bound_ms": bound, "times_ms": times}
                for name, ts in times.items():
                    print("%s %-24s %s ms (bound %.4f ms)"
                          % (key, name, ", ".join("%.4f" % t for t in ts),
                             bound), flush=True)
        words = torch.zeros(2, dtype=torch.int32, device=dev)
        report["zeroing_ms"] = cs.cuda_ms(lambda: words.zero_())
        print("floor: one zeroing launch alone %.4f ms" % report["zeroing_ms"])
    print(cs.card_line())
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
