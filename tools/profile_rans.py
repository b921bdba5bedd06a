#!/usr/bin/env python3
"""The rANS kernels (repaq_tpu_torch/csrc/rans.cu: rans_encode,
rans_layout, rans_decode) on one NVIDIA GPU: their shape sweeps, the
floors the encode's and the decode's state chains set, and an earlier
source of each timed in turns beside the current one.

    python3 tools/profile_rans.py [--parent OLD_rans.cu] [--real]
                                  [--sass OUT.txt] [--ablate]
    python3 tools/profile_rans.py --layout [--parent OLD_rans.cu]
    python3 tools/profile_rans.py --decode [--parent OLD_rans.cu] [--ablate]

Builds csrc/rans.cu with the package's nvcc flags once as the package
builds it and once for each point of SWEEP (-DREPAQ_RANS_THREADS, _WINDOW,
_BATCH: lanes a block, steps staged a window, steps a batch), one nvcc
each, in parallel, into a temporary directory, and times every build at
chip_smoke.py's RANS_SHAPES (a NovaSeq-quality order-1 section and an
order-0 one) and on an order-1 section of uniform random bytes, where all
65,536 contexts are live. With --real also on the largest order-1 section
of chip_smoke.py's SE corpus (640k reads) written to .rfqz at the default
chunks: real `.rfq` bytes with a real context spread.

OLD_rans.cu, when given, is an earlier source with the entry point
repaq_rans_encode(data, off, lanes, fc, order, steps, words, emits, final,
stream): lane offsets in device memory and no reciprocal table (``git show <commit>:repaq_tpu_torch/csrc/
rans.cu``); it and the package's build are timed in turns, old, new, new,
old. Every build is held exact against the package's, which is held exact
against rans_encode_plain. Each time is a CUDA-event median of 15 runs
with the L2 flushed (chip_smoke.cuda_ms).

The chain floor: tools/rans_chain_probe.cu runs encode_step alone on
register-held symbols and reads clock64() around it; the longest lane's
steps times those cycles at the card's maximum SM clock (nvidia-smi) is
the least time any design of this step can take. --sass writes the
package build's SASS of rans_encode_kernel for reading the chain by hand.
--ablate times the package build with its two stores a step, its symbol
loads (bytes, entries, reciprocals hoisted out of the loop on a constant
byte), or both cut out: what each costs above the chain.

--layout profiles rans_layout instead, on the encoder's outputs for
RANS_SHAPES: the package build and each point of LAYOUT_SWEEP
(-DREPAQ_LAYOUT_STEPS, _LANES: the tile's steps and lanes), each held
exact against the package's, which is held exact against
rans_layout_plain. Every time covers what the wrapper runs: the zero fill
of the payload (and of the status words) and the launch; the fill alone is
timed beside them. OLD_rans.cu is then an earlier source whose
repaq_rans_layout(words, emits, final, start, lanes, steps, payload, cap,
stream) takes no status words (PR 10's: ``git show
019f466:repaq_tpu_torch/csrc/rans.cu``), timed in turns, old, new, new,
old.

--decode profiles rans_decode instead, on the host coder's sections of
RANS_SHAPES (the shared route: their order-1 tables have 5 live contexts),
of uniform random order-1 bytes (all 256 contexts live: the global
route) and of the order-0 bytes in the format's most lanes, 65,535: the
package's wrapper (table packing, then the launch; as
decode_section_device calls it, with the host's live count, and as
rans_decode_device runs, counting them on the card), the packing alone,
and the kernel alone on tables packed beforehand, for the
package build and each point of DECODE_SWEEP (-DREPAQ_DEC_RING,
_SHARED_ROWS: ring bytes a lane, and the most live contexts that fit in
shared memory beside the rings), each exact against the package's
output, which equals the section's data; then the decode step's chain
(decode_step alone in tools/rans_chain_probe.cu: its table in shared
memory, or a 256-row table read from global memory) and the floor it
sets. OLD_rans.cu is then the PR 3 decoder, whose repaq_rans_decode(
payload, plen, lane_start, off, lanes, sym_lut, fcs, order, out, stream)
reads lane starts, offsets and an fcs table the caller builds (``git show
f541c4e:repaq_tpu_torch/csrc/rans.cu``); it is timed in turns with the
package's build, old, new, new, old, alone and with its wrapper's work
(the lane starts' zeros/cumsum/cat, the offsets' copy, the fcs gather).
--decode --ablate times the package build with a part cut out
(DECODE_ABLATIONS): the stage stores, the copy-out, the payload word's
load, or all lanes of each warp but its first, which runs the same steps
with no bank conflicts. The last line of output is one JSON object.
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
SRC = os.path.join(ROOT, "repaq_tpu_torch", "csrc", "rans.cu")
PROBE = os.path.join(ROOT, "tools", "rans_chain_probe.cu")
AS_BUILT = "as built"
OLD = "parent"
# (lanes a block, window, batch); a point whose shared memory exceeds the
# card's 227 KB is refused at launch and reported so
SWEEP = [(t, w, b) for t in (32, 64, 128) for w in (512, 1024)
         for b in (8, 16)]
PROBE_STEPS = 1 << 16
# --decode: ring bytes a lane
DECODE_SWEEP = [256, 512, 1024, 2048]
# the section format's most lanes (a u16 field)
MAX_LANES = 65535
# --decode --ablate: rans_decode with a part cut out (outputs wrong on
# purpose): the stage stores (one store a window instead), the copy-out,
# the payload word's load (a constant word), the output byte's load (the
# entry stands in), or all lanes of a warp but its first (the same steps
# with no bank conflicts)
DECODE_ABLATIONS = {
    "no stage stores": [(
        "      stage[j] = static_cast<uint8_t>(decode_step<kShared, kEven>(",
        "      stage[0] ^= static_cast<uint8_t>(decode_step<kShared, kEven>(")],
    "no copy-out": [("    for (int l = 0; l < kDecLanes; ++l) {",
                     "    for (int l = kDecLanes; l < kDecLanes; ++l) {")],
    "no word load": [("      kEven ? lds_u16(ring + at)",
                      "      kEven ? 0x5A5Au + at")],
    "no symbol load": [(
        "  const uint32_t s = kShared ? syms[kb >> 2] : (e >> 12) & 0xFFu;",
        "  const uint32_t s = e;")],
    "one lane a warp": [(
        "  ln.len = active ? q + (i < r ? 1 : 0) : 0;",
        "  ln.len = active && lane == 0 ? q + (i < r ? 1 : 0) : 0;")],
}
# --layout: (tile steps, tile lanes)
LAYOUT_SWEEP = [(t, w) for t in (64, 128, 256, 512) for w in (32, 64, 128)]
# --layout --ablate: rans_layout with a phase cut out (outputs wrong on
# purpose; cap >= 0 always holds, but the compiler cannot know it)
_WORDS_LANDED = ("  cp_async_wait_all();  // the words have landed\n"
                 "  __syncthreads();\n")
_EMITS_LANDED = ("  cp_async_wait_but_one();  // the emits have landed\n"
                 "  __syncthreads();\n")
LAYOUT_ABLATIONS = {
    "no copy-out": [("for (int l = warp; l < width; l += kLayoutWarps)",
                     "for (int l = width; l < width; l += kLayoutWarps)")],
    "no compaction": [("    while (m) {\n", "    while (m && cap < 0) {\n")],
    "no look-back": [("for (int t0 = tile + 1 + part; t0 < tiles;",
                      "for (int t0 = tiles; t0 < tiles;")],
    "no writing phases": [(_WORDS_LANDED,
                           _WORDS_LANDED + "  if (cap >= 0) return;\n")],
    "staging only": [(_EMITS_LANDED, _WORDS_LANDED
                      + "  if (cap >= 0) return;\n")],
}
# --ablate: the package build with parts of its work cut out (outputs
# wrong on purpose), as (old text, new text) edits of csrc/rans.cu
_STORES = ("  *w = static_cast<uint16_t>(x & 0xFFFFu);\n  *em = emit;\n", "")
_SYMBOLS = ("for (int u = 0; u < kBatch + kOrder; ++u) b[u] = at[-u];",
            "for (int u = 0; u < kBatch + kOrder; ++u) b[u] = 0x46u;")
ABLATIONS = {"no stores": [_STORES],
             "symbols hoisted out of the loop": [_SYMBOLS],
             "no stores, symbols hoisted": [_STORES, _SYMBOLS]}


def sweep_name(point) -> str:
    return "threads %d window %d batch %d" % point


def _nvcc_jobs(tmp: str, jobs: dict) -> dict:
    """name -> path of the library each (source, flags) job built; all
    nvcc processes run at once."""
    sys.path.insert(0, ROOT)
    from repaq_tpu_torch.ops import _build

    out_dir = tempfile.mkdtemp(dir=tmp)  # never over a loaded library
    procs = {}
    for i, (name, (src, flags)) in enumerate(jobs.items()):
        so = os.path.join(out_dir, "rans%d.so" % i)
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-shared", "-o", so,
             src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    built = {}
    for name, (so, p) in procs.items():
        out = p.communicate()[0].decode(errors="replace")
        if p.returncode:
            raise RuntimeError("nvcc failed on %r:\n%s" % (name, out))
        built[name] = so
    return built


def build(tmp: str, parent: str | None = None, sweep=SWEEP) -> dict:
    """name -> (loaded library, takes the reciprocal table) of the package
    build, each sweep point and the parent source."""
    jobs = {AS_BUILT: (SRC, [])}
    for point in sweep:
        jobs[sweep_name(point)] = (SRC, [
            "-DREPAQ_RANS_THREADS=%d" % point[0],
            "-DREPAQ_RANS_WINDOW=%d" % point[1],
            "-DREPAQ_RANS_BATCH=%d" % point[2]])
    if parent:
        jobs[OLD] = (parent, [])
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    libs = {}
    for name, so in _nvcc_jobs(tmp, jobs).items():
        lib = ctypes.CDLL(so)
        with_rcp = name != OLD
        lib.repaq_rans_encode.argtypes = (
            [vp, ll, ci, vp, vp, ci, ll, vp, vp, vp, vp] if with_rcp
            else [vp, vp, ci, vp, ci, ll, vp, vp, vp, vp])
        lib.repaq_rans_encode.restype = ci
        libs[name] = (lib, with_rcp)
    return libs


def section_inputs(dev, data, order: int, lanes: int) -> dict:
    """What one rans_encode launch takes for a section, on `dev`."""
    import numpy as np
    import torch

    from repaq_tpu_torch.codec import rans_np
    from repaq_tpu_torch.ops import rans_device as RD

    _head, freqs, cum = RD.section_prologue(data, order, lanes)
    f, c = (torch.from_numpy(a.astype(np.int32)).to(dev) for a in (freqs,
                                                                   cum))
    off = rans_np.lane_slices(data.shape[0], lanes)
    return {"d": torch.from_numpy(data).to(dev), "f": f, "c": c,
            "fc": RD._fc_table(f, c, order), "order": order, "lanes": lanes,
            "off": torch.from_numpy(off).to(dev),
            "steps": int(np.diff(off).max()), "rcp": RD._rcp_on(dev)}


def launcher(lib, with_rcp: bool, inp: dict):
    """A function that launches `lib`'s rans_encode on `inp` and returns
    (words, emits, final); raises if the launch is refused."""
    import torch

    dev = inp["d"].device
    lanes, steps = inp["lanes"], inp["steps"]

    def run():
        words = torch.empty((steps, lanes), dtype=torch.uint16, device=dev)
        emits = torch.empty((steps, lanes), dtype=torch.bool, device=dev)
        final = torch.empty(lanes, dtype=torch.int64, device=dev)
        if with_rcp:
            head = [inp["d"].data_ptr(), inp["d"].shape[0], lanes,
                    inp["fc"].data_ptr(), inp["rcp"].data_ptr()]
        else:
            head = [inp["d"].data_ptr(), inp["off"].data_ptr(), lanes,
                    inp["fc"].data_ptr()]
        rc = lib.repaq_rans_encode(
            *head, inp["order"], steps, words.data_ptr(), emits.data_ptr(),
            final.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError("rans_encode launch refused: error %d" % rc)
        return words, emits, final

    return run


def same(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def shape_cases(dev, real=None) -> dict:
    """label -> inputs: chip_smoke's RANS_SHAPES, an order-1 section of
    uniform random bytes as large as the first, and `real` ((data, lanes)
    of an order-1 section) when given."""
    import numpy as np

    import chip_smoke as cs

    cases = {}
    for order, data, lanes in cs.rans_shape_data():
        cases[cs.rans_label(order, data.shape[0], lanes, "")] = \
            section_inputs(dev, data, order, lanes)
    order, n, lanes = cs.RANS_SHAPES[0]
    data = cs.uniform_bytes(n)
    cases[cs.rans_label(order, n, lanes, ", uniform random bytes")] = \
        section_inputs(dev, data, order, lanes)
    if real is not None:
        data, lanes = real
        cases[cs.rans_label(1, data.shape[0], lanes, ", real .rfq bytes")] = \
            section_inputs(dev, np.asarray(data), 1, lanes)
    return cases


def sweep(dev, cases: dict, tmp: str) -> dict:
    """The package build and every SWEEP point timed at every case: name
    -> {case: ms, or None where the launch was refused}, each build held
    exact against the package's."""
    import chip_smoke as cs

    libs = build(tmp)
    ref = {label: launcher(*libs[AS_BUILT], inp)() for label, inp in
           cases.items()}
    res = {}
    for name, (lib, with_rcp) in libs.items():
        res[name] = {}
        for label, inp in cases.items():
            run = launcher(lib, with_rcp, inp)
            try:
                out = run()
            except RuntimeError:
                res[name][label] = None
                continue
            cs.check(same(out, ref[label]), "rans_encode built with %s "
                     "differs from the package build at %s" % (name, label))
            res[name][label] = cs.cuda_ms(run)
    return res


def ablation_jobs(tmp: str, ablations: dict) -> dict:
    """name -> (source, flags) of csrc/rans.cu with each ablation's edits
    made, written into tmp."""
    with open(SRC) as f:
        text = f.read()
    jobs = {}
    for name, edits in ablations.items():
        cut = text
        for old, new in edits:
            if old not in cut:
                raise RuntimeError("ablation %r: %r is not in %s"
                                   % (name, old, SRC))
            cut = cut.replace(old, new)
        path = os.path.join(tmp, "ablation-%s.cu" % len(os.listdir(tmp)))
        with open(path, "w") as f:
            f.write(cut)
        jobs[name] = (path, [])
    return jobs


def ablate(dev, cases: dict, tmp: str) -> dict:
    """Each of ABLATIONS, and the package build, timed at every case:
    name -> {case: ms}."""
    import chip_smoke as cs

    jobs = {AS_BUILT: (SRC, []), **ablation_jobs(tmp, ABLATIONS)}
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    res = {}
    for name, so in _nvcc_jobs(tmp, jobs).items():
        lib = ctypes.CDLL(so)
        lib.repaq_rans_encode.argtypes = [vp, ll, ci, vp, vp, ci, ll, vp, vp,
                                          vp, vp]
        lib.repaq_rans_encode.restype = ci
        res[name] = {label: cs.cuda_ms(launcher(lib, True, inp))
                     for label, inp in cases.items()}
    return res


def max_sm_clock_mhz() -> float:
    r = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm",
                        "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode:
        raise RuntimeError("nvidia-smi failed: %s" % r.stderr.strip())
    return float(r.stdout.split()[0])


def probe_lib(tmp: str):
    """tools/rans_chain_probe.cu built and loaded."""
    so = _nvcc_jobs(tmp, {"probe": (PROBE, [])})["probe"]
    lib = ctypes.CDLL(so)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.repaq_rans_chain_probe.argtypes = [vp, ci, vp, vp, vp]
    lib.repaq_rans_chain_probe.restype = ci
    lib.repaq_rans_decode_chain_probe.argtypes = [vp, vp, ci, vp, ci, ci, vp,
                                                  vp, vp]
    lib.repaq_rans_decode_chain_probe.restype = ci
    lib.repaq_rans_decode_probe_ring.argtypes = []
    lib.repaq_rans_decode_probe_ring.restype = ci
    return lib


def _probe_runs(launch, dev) -> float:
    """The median cycles a step of 5 probe runs (after one warm-up) of
    PROBE_STEPS steps; launch(cycles, out) starts one."""
    import statistics

    import torch

    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    out = torch.zeros(1, dtype=torch.int32, device=dev)
    runs = []
    for _ in range(6):
        rc = launch(cycles, out)
        if rc:
            raise RuntimeError("chain probe launch refused: error %d" % rc)
        torch.cuda.synchronize()
        runs.append(int(cycles.item()) / PROBE_STEPS)
    return statistics.median(runs[1:])


def chain_cycles(dev, lib) -> float:
    """Cycles of one encode_step on the state chain alone (the median of 5
    probe runs of PROBE_STEPS steps on NovaSeq-like order-0 symbols);
    lib: probe_lib()'s."""
    import numpy as np
    import torch

    from repaq_tpu_torch.codec import rans_np
    from repaq_tpu_torch.ops import rans_device as RD

    freqs = rans_np.quantize_freqs(np.bincount(
        np.frombuffer(b"F" * 86 + b":" * 9 + b"," * 4 + b"#", np.uint8),
        minlength=256))
    cum = np.cumsum(freqs) - freqs
    rcp = RD.rcp_table()
    syms = []
    for s in b"FF:F,FF#":
        e = int(freqs[s]) | int(cum[s]) << 16
        syms.append([e, *rcp[freqs[s]], 0])
    syms = torch.tensor(np.array(syms, dtype=np.uint32).view(np.int32),
                        device=dev)
    return _probe_runs(lambda cycles, out: lib.repaq_rans_chain_probe(
        syms.data_ptr(), PROBE_STEPS, cycles.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream), dev)


def decode_chain_cycles(dev, lib) -> dict:
    """Cycles of one decode_step on the state chain alone, {route: cycles}:
    "shared", the order-0 table of NovaSeq qualities in shared memory;
    "global", the 256-row order-1 table of uniform random bytes read from
    global memory. The payload ring holds random bytes; lib: probe_lib()'s.
    """
    import numpy as np
    import torch

    import chip_smoke as cs
    from repaq_tpu_torch.ops import rans_device as RD

    rng = np.random.default_rng(17)
    words = torch.from_numpy(rng.integers(
        0, 256, size=lib.repaq_rans_decode_probe_ring(),
        dtype=np.uint8)).to(dev)
    tables = {
        "shared": rng.choice(np.frombuffer(cs.NOVA_QUALS, np.uint8),
                             size=100_000, p=cs.NOVA_P),
        "global": cs.uniform_bytes(2_000_000)}
    res = {}
    for route, data in tables.items():
        order = 0 if route == "shared" else 1
        head, freqs, cum = RD.section_prologue(data, order, 64)
        sym = RD._parse_tables(memoryview(head), 7, order)[2]
        table, syms = RD.decode_table(*(
            torch.from_numpy(a).to(dev) for a in (sym, freqs, cum)), order,
            1 if order == 0 else None)

        def launch(cycles, out, table=table, syms=syms):
            return lib.repaq_rans_decode_chain_probe(
                table.data_ptr(), None if syms is None else syms.data_ptr(),
                table.shape[0],
                words.data_ptr(), 0x00C0FFEE, PROBE_STEPS, cycles.data_ptr(),
                out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)

        res[route] = _probe_runs(launch, dev)
    return res


def chain_floor_ms(steps: int, cycles: float, mhz: float) -> float:
    return steps * cycles / (mhz * 1e3)


def real_section(tmp: str):
    """(data, lanes) of the largest order-1 section of chip_smoke's SE
    corpus written to .rfqz at the default chunks (host coder)."""
    import numpy as np

    import chip_smoke as cs
    from repaq_tpu_torch import cli
    from repaq_tpu_torch.codec import rans_np

    fq = os.path.join(tmp, "se1.fq")
    cs.make_corpus([fq], 640_000, 150, seed=96)
    best = [np.zeros(0, np.uint8), 0]
    encode = rans_np.encode_section

    def recording(arr, order=0, lanes=rans_np.DEFAULT_LANES, **kw):
        if order == 1 and len(arr) > best[0].shape[0]:
            best[:] = [np.array(arr, dtype=np.uint8),
                       max(1, min(lanes, len(arr)))]
        return encode(arr, order=order, lanes=lanes, **kw)

    rans_np.encode_section = recording
    try:
        rc = cli.main(["-c", "-i", fq, "-o", os.path.join(tmp, "se.rfqz"),
                       "--engine", "vectorized"])
    finally:
        rans_np.encode_section = encode
    if rc:
        raise RuntimeError("the .rfqz compress exited %d" % rc)
    return best[0], best[1]


def write_sass(tmp: str, path: str) -> None:
    from repaq_tpu_torch.ops import _build

    so = _nvcc_jobs(tmp, {"sass": (SRC, [])})["sass"]
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    r = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                       text=True)
    if r.returncode:
        raise RuntimeError("cuobjdump failed: %s" % r.stderr)
    lines, keep = [], False
    for line in r.stdout.splitlines():
        if "Function : " in line:
            keep = "rans_encode_kernel" in line
        if keep:
            lines.append(line)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def layout_name(point) -> str:
    return "tile %d steps x %d lanes" % point


def layout_build(tmp: str, parent: str | None = None,
                 ablations: dict | None = None) -> dict:
    """name -> (loaded library, takes status words) of the package build,
    each LAYOUT_SWEEP point, each of `ablations` and the parent source."""
    jobs = {AS_BUILT: (SRC, [])}
    for point in LAYOUT_SWEEP:
        jobs[layout_name(point)] = (SRC, [
            "-DREPAQ_LAYOUT_STEPS=%d" % point[0],
            "-DREPAQ_LAYOUT_LANES=%d" % point[1]])
    jobs.update(ablation_jobs(tmp, ablations or {}))
    if parent:
        jobs[OLD] = (parent, [])
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    libs = {}
    for name, so in _nvcc_jobs(tmp, jobs).items():
        lib = ctypes.CDLL(so)
        with_status = name != OLD
        lib.repaq_rans_layout.argtypes = (
            [vp, vp, vp, vp, ci, ll, vp, ll, vp, vp] if with_status
            else [vp, vp, vp, vp, ci, ll, vp, ll, vp])
        lib.repaq_rans_layout.restype = ci
        if with_status:
            lib.repaq_rans_layout_status_words.argtypes = [ci, ll]
            lib.repaq_rans_layout_status_words.restype = ll
        libs[name] = (lib, with_status)
    return libs


def layout_cases(dev) -> dict:
    """label -> (words, emits, final, start, out_cap) of RANS_SHAPES: the
    package encoder's outputs, the section coder's starts and cap."""
    import torch

    import chip_smoke as cs
    from repaq_tpu_torch.ops import rans_device as RD

    cases = {}
    for order, data, lanes in cs.rans_shape_data():
        inp = section_inputs(dev, data, order, lanes)
        words, emits, final = RD.rans_encode_device(inp["d"], inp["f"],
                                                    inp["c"], lanes, order)
        size = 4 + 2 * emits.sum(0)
        start = torch.cumsum(size, 0) - size
        cases[cs.rans_label(order, data.shape[0], lanes, "")] = (
            words, emits, final, start, 2 * data.shape[0] + 4 * lanes + 8)
    return cases


def layout_launcher(lib, with_status: bool, inp, fill: bool = True):
    """A function that runs what the wrapper runs with `lib`'s rans_layout
    on `inp` (the zero fill, then the launch) and returns the payload;
    raises if the launch is refused. fill=False zeroes only the status
    words, and the kernel writes into a payload allocated once, left as
    the last run wrote it: the kernel's time without the payload's fill."""
    import torch

    words, emits, final, start, cap = inp
    steps, lanes = words.shape
    head = -(-cap // 16) * 16
    extra = (4 * lib.repaq_rans_layout_status_words(lanes, steps)
             if with_status else 0)
    kept = torch.zeros(head, dtype=torch.uint8, device=words.device)

    def run():
        if fill:
            buf = torch.zeros(head + extra, dtype=torch.uint8,
                              device=words.device)
            payload, status = buf, buf[head:]
        else:
            payload = kept
            status = torch.zeros(extra, dtype=torch.uint8,
                                 device=words.device)
        tail = [status.data_ptr()] if with_status else []
        rc = lib.repaq_rans_layout(
            words.data_ptr(), emits.data_ptr(), final.data_ptr(),
            start.data_ptr(), lanes, steps, payload.data_ptr(), cap, *tail,
            torch.cuda.current_stream(words.device).cuda_stream)
        if rc:
            raise RuntimeError("rans_layout launch refused: error %d" % rc)
        return payload[:cap]

    return run


def layout_profile(dev, tmp: str, parent: str | None,
                   ablate: bool = False) -> dict:
    """The layout's fill alone, the parent in turns (when given), the
    sweep and, with `ablate`, LAYOUT_ABLATIONS, printed; the readings."""
    import torch

    import chip_smoke as cs
    from repaq_tpu_torch.ops import rans_device as RD

    cases = layout_cases(dev)
    cut = LAYOUT_ABLATIONS if ablate else {}
    libs = layout_build(tmp, parent, cut)
    result = {"tile": list(RD.layout_tile()), "fill_ms": {}, "sweep": {}}
    ref = {}
    for label, inp in cases.items():
        ref[label] = RD.rans_layout(*inp)
        cs.check(torch.equal(ref[label], RD.rans_layout_plain(*inp)),
                 "rans_layout differs from its plain version at %s" % label)
        cap = inp[4]
        result["fill_ms"][label] = ms = cs.cuda_ms(
            lambda: torch.zeros(cap, dtype=torch.uint8, device=dev))
        print("layout fill at %s: %d B alone %.4f ms" % (label, cap, ms),
              flush=True)
    if parent:
        turns = {}
        for label, inp in cases.items():
            runs = {name: layout_launcher(*libs[name], inp)
                    for name in (OLD, AS_BUILT)}
            for name, run in runs.items():
                cs.check(torch.equal(run(), ref[label]), "rans_layout of %s "
                         "differs from the package's at %s" % (name, label))
            times = [(name, cs.cuda_ms(runs[name]))
                     for name in (OLD, AS_BUILT, AS_BUILT, OLD)]
            turns[label] = times
            print("layout turns at %s: %s" % (label, ", ".join(
                "%s %.4f ms" % t for t in times)), flush=True)
        result["turns"] = turns
    if ablate:
        result["ablations"] = {}
        for name in (AS_BUILT, *cut):
            lib, with_status = libs[name]
            result["ablations"][name] = times = {}
            for label, inp in cases.items():
                small = layout_launcher(lib, with_status, inp, fill=False)
                times[label] = [
                    cs.cuda_ms(layout_launcher(lib, with_status, inp)),
                    cs.cuda_ms(small), cs.cuda_ms(small, clean=True)]
            print("layout ablation %-18s %s" % (name, "; ".join(
                "%s %.4f ms, %.4f without the payload's fill, %.4f so after "
                "a clean flush" % (label, *ms)
                for label, ms in times.items())), flush=True)
        result["status_fill_ms"] = {}
        for label, inp in cases.items():
            extra = 4 * libs[AS_BUILT][0].repaq_rans_layout_status_words(
                inp[0].shape[1], inp[0].shape[0])

            def zeros():
                return torch.zeros(extra, dtype=torch.uint8, device=dev)

            result["status_fill_ms"][label] = ms = [
                cs.cuda_ms(zeros), cs.cuda_ms(zeros, clean=True)]
            print("layout status fill alone at %s: %d B %.4f ms, %.4f after "
                  "a clean flush" % (label, extra, *ms), flush=True)
    for name, (lib, with_status) in libs.items():
        if name == OLD or name in cut:
            continue
        result["sweep"][name] = times = {}
        for label, inp in cases.items():
            run = layout_launcher(lib, with_status, inp)
            try:
                out = run()
            except RuntimeError:
                times[label] = None
                continue
            cs.check(torch.equal(out, ref[label]), "rans_layout built with "
                     "%s differs from the package build at %s"
                     % (name, label))
            times[label] = cs.cuda_ms(run)
        print("layout sweep %-28s %s" % (name, "; ".join(
            "%s %s" % (label, "refused" if ms is None else "%.4f ms" % ms)
            for label, ms in times.items())), flush=True)
    return result


def decode_name(ring: int) -> str:
    return "ring %d" % ring


def decode_shared_rows(ring: int) -> int:
    """The most packed rows (20 KB each) that fit in a block's 227 KB
    beside 32 lanes' rings, two stages and their runs (the static_assert
    of csrc/rans.cu)."""
    window = ring // 4 - 4
    stage = 4 * (((window + 3) // 4) | 1)
    lanes = 32 * (ring + 16) + 2 * 32 * stage + 2 * 32 * 16
    return min(256, (232448 - lanes) // (5 << 12))


def decode_build(tmp: str, parent: str | None = None,
                 ablations: dict | None = None) -> dict:
    """name -> (loaded library, takes packed tables) of the package build,
    each DECODE_SWEEP point, each of `ablations` and the parent source."""
    jobs = {AS_BUILT: (SRC, [])}
    for ring in DECODE_SWEEP:
        jobs[decode_name(ring)] = (SRC, [
            "-DREPAQ_DEC_RING=%d" % ring,
            "-DREPAQ_DEC_SHARED_ROWS=%d" % decode_shared_rows(ring)])
    jobs.update(ablation_jobs(tmp, ablations or {}))
    if parent:
        jobs[OLD] = (parent, [])
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    libs = {}
    for name, so in _nvcc_jobs(tmp, jobs).items():
        lib = ctypes.CDLL(so)
        packed = name != OLD
        lib.repaq_rans_decode.argtypes = (
            [vp, ll, vp, ci, ll, vp, vp, ci, ci, ci, vp, vp] if packed
            else [vp, ll, vp, vp, ci, vp, vp, ci, vp, vp])
        lib.repaq_rans_decode.restype = ci
        libs[name] = (lib, packed)
    return libs


def decode_cases(dev) -> dict:
    """label -> inputs of rans_decode: the host coder's sections of
    RANS_SHAPES, of uniform random order-1 bytes (2048 lanes) and of
    RANS_SHAPES' order-0 bytes in MAX_LANES lanes on `dev`, with the data,
    the packed tables and the longest lane."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from repaq_tpu_torch.ops import rans_device as RD

    sections = [(order, data, lanes, "") for order, data, lanes in
                cs.rans_shape_data()]
    order, n, lanes = cs.RANS_SHAPES[0]
    sections.append((order, cs.uniform_bytes(n), lanes,
                     ", uniform random bytes"))
    # the order-0 section in the most lanes the section format holds,
    # where the kernel's sums of the counts before each block are longest
    sections.append((0, sections[1][1], MAX_LANES, ", the format's most "
                     "lanes"))
    cases = {}
    for order, data, lanes, what in sections:
        args, off = cs.decode_case_inputs(dev, order, data, lanes, 0)
        live = RD._live_of(args[3], order)
        shared = order == 0 or live <= RD.decode_shared_rows()
        table, syms = RD.decode_table(*args[2:5], order,
                                      live if shared else None)
        cases[cs.rans_label(order, data.shape[0], lanes, what)] = {
            "args": args, "off": off, "data": data, "order": order,
            "lanes": lanes, "n": data.shape[0],
            "steps": int(np.diff(off).max()), "table": table,
            "syms": syms, "live": live, "shared": shared}
    return cases


def decode_launcher(lib, packed: bool, inp):
    """A function that launches `lib`'s rans_decode alone on `inp` (its
    tables packed beforehand for the package's route, or the parent's lane
    starts, offsets and fcs table built beforehand) and returns the
    output; raises if the launch is refused (a build whose shared table
    holds fewer rows than the case's live contexts)."""
    import torch

    payload, counts, sym = inp["args"][:3]
    dev = payload.device
    order, lanes, n = inp["order"], inp["lanes"], inp["n"]
    if packed:
        table = inp["table"]
        syms = inp["syms"]
        held = (table, syms)
        args = [counts.data_ptr(), lanes, n, table.data_ptr(),
                None if syms is None else syms.data_ptr(), table.shape[0],
                int(inp["shared"]), order]
    else:
        held = start, off, fcs = parent_inputs(inp)
        args = [start.data_ptr(), off.data_ptr(), lanes, sym.data_ptr(),
                fcs.data_ptr(), order]

    # held: the tensors whose pointers args holds, alive as long as run
    def run(held=held):
        out = torch.empty(n, dtype=torch.uint8, device=dev)
        rc = lib.repaq_rans_decode(
            payload.data_ptr(), payload.shape[0], *args, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError("rans_decode launch refused: error %d" % rc)
        return out

    return run


def parent_inputs(inp):
    """What the parent's wrapper built before its launch: lane starts
    (zeros, cumsum, cat), offsets (a copy from the host) and the fcs table
    (each slot's freq | cum << 16, a gather)."""
    import torch

    from repaq_tpu_torch.ops import rans_device as RD

    payload, counts, sym, f, c = inp["args"][:5]
    dev = payload.device
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    start = torch.cat([zero, torch.cumsum(counts.long(), 0)])
    off = torch.from_numpy(inp["off"]).to(dev)
    rows = 1 if inp["order"] == 0 else 256
    fc = RD._fc_table(f, c, inp["order"])
    fcs = fc.view(rows, 256).gather(1, sym.reshape(rows, RD.SCALE).long())
    return start, off, fcs


def decode_profile(dev, tmp: str, parent: str | None,
                   ablate: bool = False) -> dict:
    """The package's wrapper and its table packing alone at every case,
    the parent in turns (when given), the sweep, with `ablate`
    DECODE_ABLATIONS, and the chain floor, printed; the readings."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from repaq_tpu_torch.ops import rans_device as RD

    cases = decode_cases(dev)
    cut = DECODE_ABLATIONS if ablate else {}
    libs = decode_build(tmp, parent, cut)
    result = {"window": RD.decode_window(),
              "shared_rows": RD.decode_shared_rows(), "cases": {},
              "sweep": {}}
    ref = {}
    for label, inp in cases.items():
        args, off = inp["args"], inp["off"]

        def wrapper(args=args, off=off, live=inp["live"]):
            return RD._rans_decode(*args, off, live)

        def reading(args=args, off=off):
            return RD.rans_decode_device(*args, offsets=off)

        ref[label] = wrapper()
        cs.check(np.array_equal(ref[label].cpu().numpy(), inp["data"]),
                 "rans_decode did not give the section back at %s" % label)
        table_ms = cs.cuda_ms(lambda inp=inp: RD.decode_table(
            *inp["args"][2:5], inp["order"],
            inp["live"] if inp["shared"] else None))
        route = RD.last_decode[2]
        result["cases"][label] = r = {
            "route": route, "live": inp["live"], "steps": inp["steps"],
            "wrapper_ms": cs.cuda_ms(wrapper), "table_ms": table_ms,
            "reading_wrapper_ms": cs.cuda_ms(reading),
            "kernel_ms": cs.cuda_ms(decode_launcher(*libs[AS_BUILT], inp))}
        print("decode at %s: %s route, %d live contexts; wrapper %.4f ms "
              "(%.4f ms when it reads the live count from the card), its "
              "table packing alone %.4f ms, kernel alone %.4f ms"
              % (label, route, inp["live"], r["wrapper_ms"],
                 r["reading_wrapper_ms"], table_ms, r["kernel_ms"]),
              flush=True)
    if parent:
        turns = {}
        for label, inp in cases.items():
            old = decode_launcher(*libs[OLD], inp)
            new = decode_launcher(*libs[AS_BUILT], inp)
            cs.check(torch.equal(old(), ref[label]) and
                     torch.equal(new(), ref[label]), "the parent's or the "
                     "package's kernel differs from the wrapper at %s"
                     % label)
            lib = libs[OLD][0]

            def old_wrapper(inp=inp, lib=lib):
                return decode_launcher(lib, False, inp)()

            def new_wrapper(inp=inp):
                return RD._rans_decode(*inp["args"], inp["off"], inp["live"])

            runs = {"parent kernel": old, "kernel": new,
                    "parent wrapper": old_wrapper, "wrapper": new_wrapper}
            times = [(name, cs.cuda_ms(runs[name])) for name in (
                "parent kernel", "kernel", "kernel", "parent kernel",
                "parent wrapper", "wrapper", "wrapper", "parent wrapper")]
            turns[label] = times
            print("decode turns at %s: %s" % (label, ", ".join(
                "%s %.4f ms" % t for t in times)), flush=True)
        result["turns"] = turns
    if ablate:
        result["ablations"] = {}
        for name in (AS_BUILT, *cut):
            result["ablations"][name] = times = {
                label: cs.cuda_ms(decode_launcher(*libs[name], inp))
                for label, inp in cases.items()}
            print("decode ablation %-18s %s" % (name, "; ".join(
                "%s %.4f ms, %.1f ns a step" % (
                    label, ms, 1e6 * ms / cases[label]["steps"])
                for label, ms in times.items())), flush=True)
    for name, (lib, packed) in libs.items():
        if name == OLD or name in cut:
            continue
        result["sweep"][name] = times = {}
        for label, inp in cases.items():
            run = decode_launcher(lib, packed, inp)
            try:
                out = run()
            except RuntimeError:
                times[label] = None
                continue
            cs.check(torch.equal(out, ref[label]), "rans_decode built with "
                     "%s differs from the package build at %s"
                     % (name, label))
            times[label] = cs.cuda_ms(run)
        print("decode sweep %-22s %s" % (name, "; ".join(
            "%s %s" % (label, "refused" if ms is None else "%.4f ms" % ms)
            for label, ms in times.items())), flush=True)
    cyc = decode_chain_cycles(dev, probe_lib(tmp))
    mhz = max_sm_clock_mhz()
    result.update(chain_cycles=cyc, max_sm_mhz=mhz)
    for label, r in result["cases"].items():
        r["chain_floor_ms"] = chain_floor_ms(r["steps"], cyc[r["route"]],
                                             mhz)
        print("decode chain at %s: %d steps x %.2f cycles (%s table) at "
              "%.0f MHz = %.4f ms; the kernel alone %.4f ms (%.0f%% of the "
              "floor's rate)" % (label, r["steps"], cyc[r["route"]],
                                 r["route"], mhz, r["chain_floor_ms"],
                                 r["kernel_ms"],
                                 100 * r["chain_floor_ms"] / r["kernel_ms"]),
              flush=True)
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an earlier csrc/rans.cu to time")
    ap.add_argument("--real", action="store_true",
                    help="also time the SE corpus's largest order-1 section")
    ap.add_argument("--sass", help="write rans_encode_kernel's SASS here")
    ap.add_argument("--ablate", action="store_true",
                    help="also time the build with its stores, its symbol "
                         "loads, or both cut out (ABLATIONS)")
    ap.add_argument("--layout", action="store_true",
                    help="profile rans_layout instead (LAYOUT_SWEEP; "
                         "--parent then takes PR 10's source)")
    ap.add_argument("--decode", action="store_true",
                    help="profile rans_decode instead (DECODE_SWEEP; "
                         "--parent then takes PR 13's source)")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("profile_rans: torch sees no CUDA device")
        return 2
    dev = torch.device("cuda:0")
    from repaq_tpu_torch.ops import rans_device as RD

    card = cs.card_line()
    result = {"card": card}
    if args.layout or args.decode:
        with tempfile.TemporaryDirectory() as tmp:
            result.update(
                layout_profile(dev, tmp, args.parent, args.ablate)
                if args.layout else decode_profile(dev, tmp, args.parent,
                                                   args.ablate))
        print(card)
        print(json.dumps(result))
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        real = real_section(tmp) if args.real else None
        cases = shape_cases(dev, real)
        for label, inp in cases.items():
            want = RD.rans_encode_plain(inp["d"], inp["f"], inp["c"],
                                        inp["lanes"], inp["order"])
            got = RD.rans_encode_device(inp["d"], inp["f"], inp["c"],
                                        inp["lanes"], inp["order"])
            cs.check(same(got, want), "rans_encode differs from its plain "
                     "version at %s" % label)
        libs = build(tmp, args.parent, sweep=())
        if args.parent:
            turns = {}
            for label, inp in cases.items():
                runs = {name: launcher(*libs[name], inp)
                        for name in (OLD, AS_BUILT)}
                cs.check(same(runs[OLD](), runs[AS_BUILT]()), "the parent "
                         "kernel differs from this one at %s" % label)
                order = [OLD, AS_BUILT, AS_BUILT, OLD]
                times = [(name, cs.cuda_ms(runs[name])) for name in order]
                turns[label] = times
                print("turns at %s: %s" % (label, ", ".join(
                    "%s %.4f ms" % t for t in times)), flush=True)
            result["turns"] = turns
        swept = sweep(dev, cases, tmp)
        for name, times in swept.items():
            print("sweep %-32s %s" % (name, "; ".join(
                "%s %s" % (label, "refused" if ms is None else "%.4f ms" % ms)
                for label, ms in times.items())), flush=True)
        result["sweep"] = swept
        if args.ablate:
            cut = ablate(dev, cases, tmp)
            for name, times in cut.items():
                print("ablation %-32s %s" % (name, "; ".join(
                    "%s %.4f ms, %.1f ns a step" % (
                        label, ms, 1e6 * ms / cases[label]["steps"])
                    for label, ms in times.items())), flush=True)
            result["ablations"] = cut
        cyc = chain_cycles(dev, probe_lib(tmp))
        mhz = max_sm_clock_mhz()
        floors = {label: chain_floor_ms(inp["steps"], cyc, mhz)
                  for label, inp in cases.items()}
        print("chain: %.2f cycles a step at up to %.0f MHz; floor %s"
              % (cyc, mhz, "; ".join("%s %.4f ms (%d steps)"
                                     % (label, ms, cases[label]["steps"])
                                     for label, ms in floors.items())),
              flush=True)
        result.update({"chain_cycles": cyc, "max_sm_mhz": mhz,
                       "chain_floor_ms": floors})
        if args.sass:
            write_sass(tmp, args.sass)
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
