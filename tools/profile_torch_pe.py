#!/usr/bin/env python3
"""Where the time of the PyTorch/CUDA port's paired-end path goes, on one
CUDA card: chip_smoke.py's seeded PE corpus (2 x 320k reads of 150 bp in
12-Mbase chunks) through ``repaq_tpu_torch.cli.main``, one cold round trip,
then one warm encode and one warm decode, each under ``torch.profiler``.
With ``--se``, chip_smoke.py's single-end corpus instead (640k reads of
150 bp, the same chunks).

Run from the root of a checkout on a machine with a card:

    python3 tools/profile_torch_pe.py [--se] [--pairs N] [--workers 8,1]
                                      [--tree DIR] [--stack]

``--tree DIR`` profiles the package of another checkout (for example the
parent commit, unpacked with ``git archive`` into a git-ignored
directory) with this script's report, so two trees can be read in turns
by the same measurement.

For each worker count and direction it prints the wall time, the device
time (kernels and copies, summed, and each apart), the device's idle share
of the wall,
the launches on the device (kernels, then copies and fills), the
run-boundary kernels' device time and share (the port's kernels of
csrc/scan.cu, and torch's cummax/cummin kernels should any run), and so
for the overlap, compaction, emission and run-write kernels, the
host-device copies, the kernels with the most device time, and the time
inside each of the engine's named stage ranges (``enc.*`` / ``dec.*``,
see repaq_tpu_torch/codec/device_engine.py and ops/device_streams.py) with
the torch kernels (and their device time) and the copies and fills
launched inside it, and every kernel whose device start lies in its
device-side window (the port's kernels, launched through ctypes under no
torch op, are placed in a range only so), every
``aten::index_put_`` (a scatter) by the range it ran in and by its target
and value shapes, with its device time and calls, the sort kernels'
device time and launches, and every ``aten::sort`` by the range it ran in
and by its keys' shape. The profiler records
the ranges of the thread that runs it only, so they show with one worker,
where the pipeline runs each chunk inline. Last, the first chunk's
quality scan (``DeviceEngine.quality_stats``, which the header takes; a
range ``enc.stats`` since the scan is one kernel) on the corpus's first
12-Mbase block of the first file: its wall per call (uploads, device work
and the copy back; median of 9) and its kernels' device time a call under
the profiler, by name.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from torch.autograd import DeviceType

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _is_copy(name: str) -> bool:
    return "Memcpy" in name or "Memset" in name


def _launched_under(e) -> tuple:
    """(kernels, copies and fills) launched by host event e and the ops
    below it (a range's own device-side extent is not a launch)."""
    ops = [k.name for k in e.kernels
           if not k.name.startswith(("enc.", "dec."))]
    kern = sum(not _is_copy(name) for name in ops)
    copies = len(ops) - kern
    for c in e.cpu_children:
        k, cp = _launched_under(c)
        kern, copies = kern + k, copies + cp
    return kern, copies


def _kernel_us_under(e) -> float:
    """Device time (us) of the kernels launched by host event e and the
    ops below it."""
    return (sum(k.duration for k in e.kernels if not _is_copy(k.name))
            + sum(_kernel_us_under(c) for c in e.cpu_children))


def _range_of(e) -> str:
    """The innermost enc.*/dec.* range around host event e, or '-'."""
    p = e.cpu_parent
    while p is not None:
        if p.name.startswith(("enc.", "dec.")):
            return p.name
        p = p.cpu_parent
    return "-"


def _site(e) -> str:
    """The innermost frame of this repo's code in op e's Python stack
    (recorded with --stack), else ''."""
    for frame in e.stack or ():
        if "repaq_tpu_torch" in frame or "chip_smoke" in frame:
            return frame
    return ""


def by_name_report(prof, top: int = 8) -> None:
    """Each range's torch kernels, copies and fills by name (the range of
    the op that launched them; '-' for none): launches and device ms, the
    op that launched them and, with --stack, the line of the port that ran
    the op. The port's kernels launch through ctypes, under no torch op,
    and show by name in the kernel counts above instead."""
    sites = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            continue
        rng = e.name if e.name.startswith(("enc.", "dec.")) else _range_of(e)
        for k in e.kernels:
            if k.name.startswith(("enc.", "dec.")):
                continue
            key = (rng, k.name, e.name, _site(e))
            n, us = sites.get(key, (0, 0.0))
            sites[key] = (n + 1, us + k.duration)
    for rng in sorted({key[0] for key in sites}):
        rows = sorted(((us, n, key[1:]) for key, (n, us) in sites.items()
                       if key[0] == rng), reverse=True)
        for us, n, (k, op, site) in rows[:top]:
            print("    in %-15s %5d x %8.3f ms  %s  (by %s%s)"
                  % (rng, n, us / 1e3, k[:90], op,
                     ", " + site if site else ""))
        if len(rows) > top:
            print("    in %-15s %d more kernels, %.3f ms"
                  % (rng, len(rows) - top,
                     sum(us for us, _n, _k in rows[top:]) / 1e3))


def index_put_report(prof) -> None:
    """Every aten::index_put_ (a scatter) by the range it ran in and its
    shapes: device ms, calls, entries written. Shapes are the target's
    and the values' (a scalar value, [], writes one entry per index)."""
    sites = {}
    for e in prof.events():
        if e.name != "aten::index_put_" or e.cpu_parent is not None and \
                e.cpu_parent.name == "aten::index_put_":
            continue
        shapes = e.input_shapes or []
        target = tuple(shapes[0]) if shapes else ()
        values = tuple(shapes[2]) if len(shapes) > 2 else ()
        key = (_range_of(e), target, values)
        us, calls = sites.get(key, (0.0, 0))
        sites[key] = (us + _kernel_us_under(e), calls + 1)
    total = sum(us for us, _c in sites.values())
    print("  index_put_: %.3f ms device, %d calls"
          % (total / 1e3, sum(c for _u, c in sites.values())))
    for (rng, target, values), (us, calls) in sorted(
            sites.items(), key=lambda kv: -kv[1][0]):
        print("    index_put_ in %-15s %8.3f ms %4d calls, target %s, "
              "values %s" % (rng, us / 1e3, calls, list(target),
                             list(values)))


# the port's kernels (repaq_tpu_torch/csrc/*.cu), by the start of their
# names after "(anonymous namespace)::"
_PORT_KERNELS = ("bucket_compact_", "compact_", "coords_kernel", "emit_kernel",
                 "fill_runs_", "runs_check_", "runs_tile_", "frontend_",
                 "pack_kernel", "overlap_kernel", "pe_encode_", "pe_decode_",
                 "parse_kernel", "rans_", "run_offsets_", "seg_positions_",
                 "stats_kernel", "token_fsm_", "unpack_kernel")


def _is_port(name: str) -> bool:
    at = name.find("(anonymous namespace)::")
    return at >= 0 and name[at + 23:].startswith(_PORT_KERNELS)


def _in_windows(windows: list, kernels: list) -> dict:
    """range name -> (all kernels, their device us, the port's kernels,
    their device us) of the kernels whose device start lies inside one of
    the range's device-side windows (the ranges of one worker's serial
    chunks do not overlap; a nested range's kernels count for both). The
    port's kernels launch through ctypes, under no torch op, so only their
    device time places them in a range."""
    out = {}
    for name, lo, hi in windows:
        n, us, pn, pus = out.get(name, (0, 0.0, 0, 0.0))
        for kname, start, dur in kernels:
            if lo <= start <= hi:
                n, us = n + 1, us + dur
                if _is_port(kname):
                    pn, pus = pn + 1, pus + dur
        out[name] = (n, us, pn, pus)
    return out


def report(label: str, prof, wall: float) -> None:
    dev_spans, host_spans, kernels, counts = {}, {}, {}, {}
    windows, kevents = [], []
    busy = 0.0
    for e in prof.events():
        ranged = e.name.startswith(("enc.", "dec."))
        if e.device_type != DeviceType.CUDA:
            if ranged:  # the host side of a named range: time, calls and
                # the device work it launched
                t, c, k, cp, ku = host_spans.get(e.name, (0.0, 0, 0, 0, 0.0))
                dk, dcp = _launched_under(e)
                host_spans[e.name] = (t + e.cpu_time_total, c + 1, k + dk,
                                      cp + dcp, ku + _kernel_us_under(e))
            continue
        us = e.time_range.elapsed_us()
        if ranged:  # the device-side extent of a named range
            dev_spans[e.name] = dev_spans.get(e.name, 0.0) + us
            windows.append((e.name, e.time_range.start, e.time_range.end))
        else:
            if not _is_copy(e.name):
                kevents.append((e.name, e.time_range.start, us))
            busy += us
            kernels[e.name] = kernels.get(e.name, 0.0) + us
            counts[e.name] = counts.get(e.name, 0) + 1
    copies = sum(c for k, c in counts.items() if _is_copy(k))
    copy_us = sum(v for k, v in kernels.items() if _is_copy(k))
    print("%s: wall %.3f s, device %.3f s (kernels %.3f ms, copies and fills "
          "%.3f ms), device idle %.1f%% of the wall; %d kernel launches, %d "
          "copies and fills"
          % (label, wall, busy / 1e6, (busy - copy_us) / 1e3, copy_us / 1e3,
             100 * (1 - busy / 1e6 / wall), sum(counts.values()) - copies,
             copies))
    for what, keys in (("the port's run-boundary", ("run_offsets_kernel",
                                       "seg_positions_kernel",
                                       "run_boundary_scan")),
                       ("torch's cummax/cummin", ("with_indices",)),
                       ("the port's overlap", ("overlap_kernel",)),
                       ("the port's PE pair encode", ("pe_encode_kernel",)),
                       ("the port's PE row decode", ("pe_decode_kernel",)),
                       ("the port's compaction", ("bucket_compact",
                                                  "compact_mask_kernel",
                                                  "compact_reg_")),
                       ("the port's emission", ("emit_kernel",)),
                       ("the port's coordinate streams", ("coords_kernel",)),
                       ("the port's quality scan", ("stats_kernel",)),
                       ("torch's histogram", ("Histogram",)),
                       ("the port's parse", ("parse_kernel",)),
                       ("the port's run writes", ("fill_runs_kernel",)),
                       ("the port's sorted-run writes",
                        ("runs_check_kernel", "runs_tile_kernel"))):
        hit = [k for k in kernels if any(key in k for key in keys)]
        us = sum(kernels[k] for k in hit)
        print("  kernels (%s) %.3f ms, %.2f%% of the device "
              "time, %d launches" % (what, us / 1e3, 100 * us / max(busy, 1e-9),
                                     sum(counts[k] for k in hit)))
    placed = _in_windows(windows, kevents)
    for name in sorted(set(dev_spans) | set(host_spans)):
        t, c, k, cp, ku = host_spans.get(name, (0.0, 0, 0, 0, 0.0))
        n, us, pn, pus = placed.get(name, (0, 0.0, 0, 0.0))
        print("  range %-15s device extent %.3f ms, host %.1f ms, %d calls; "
              "%d kernel launches (%.3f ms of device time), %d copies and "
              "fills inside; in its device window %d kernels (%.3f ms), of "
              "them the port's %d (%.3f ms)"
              % (name, dev_spans.get(name, 0.0) / 1e3, t / 1e3, c, k,
                 ku / 1e3, cp, n, us / 1e3, pn, pus / 1e3))
    by_name_report(prof)
    for k, v in sorted(kernels.items(), key=lambda kv: -kv[1]):
        if _is_copy(k):
            print("  copy  %-40s %.1f ms" % (k[:40], v / 1e3))
    for k, v in sorted(kernels.items(), key=lambda kv: -kv[1])[:15]:
        print("  kernel %6.1f ms %5.1f%%  %s"
              % (v / 1e3, 100 * v / max(busy, 1e-9), k[:110]))
    index_put_report(prof)
    sort_report(prof, kernels, counts, busy)


def _is_sort(name: str) -> bool:
    """A sort's device kernel (cub's radix sort passes, torch's bitonic
    and segmented sorts); searchsorted is a search."""
    low = name.lower()
    return "sort" in low and "searchsorted" not in low and not _is_copy(name)


def sort_report(prof, kernels: dict, counts: dict, busy: float) -> None:
    """The sort kernels' device time and launches, then every aten::sort by
    the range it ran in and by its input's shape: device ms and calls."""
    hit = [k for k in kernels if _is_sort(k)]
    us = sum(kernels[k] for k in hit)
    print("  sort kernels %.3f ms, %.2f%% of the device time, %d launches"
          % (us / 1e3, 100 * us / max(busy, 1e-9),
             sum(counts[k] for k in hit)))
    sites = {}
    for e in prof.events():
        if e.name != "aten::sort" or e.cpu_parent is not None and \
                e.cpu_parent.name == "aten::sort":
            continue
        shapes = e.input_shapes or []
        key = (_range_of(e), tuple(shapes[0]) if shapes else ())
        t, calls = sites.get(key, (0.0, 0))
        sites[key] = (t + _kernel_us_under(e), calls + 1)
    for (rng, shape), (t, calls) in sorted(sites.items(),
                                           key=lambda kv: -kv[1][0]):
        print("    sort in %-15s %8.3f ms %4d calls, keys %s"
              % (rng, t / 1e3, calls, list(shape)))


def stats_report(eng, path: str, runs: int = 9) -> None:
    """The engine's quality scan of the first 12-Mbase block of path: wall
    per call (median of runs; each call ends in its copy back) and, under
    the profiler, its device operations a call by name with their time."""
    import statistics

    import torch

    from repaq_tpu_torch.io.fastq import FastqReader

    reader = FastqReader(path)
    block, _ = reader.read_block(budget_bases=12_000_000)
    reader.close()
    eng.quality_stats(block)  # warm
    walls = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.quality_stats(block)
        walls.append(time.perf_counter() - t0)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(runs):
            eng.quality_stats(block)
        torch.cuda.synchronize()
    ops = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.name.startswith(
                ("enc.", "dec.")):
            n, us = ops.get(e.name, (0, 0.0))
            ops[e.name] = (n + 1, us + e.time_range.elapsed_us())
    kern_us = sum(us for k, (_n, us) in ops.items() if not _is_copy(k))
    print("quality scan of %d bases: wall %.3f ms a call (median of %d), "
          "kernels %.4f ms a call, %d device operations a call"
          % (block.qual_flat.shape[0], 1e3 * statistics.median(walls), runs,
             kern_us / runs / 1e3, sum(n for n, _u in ops.values()) // runs))
    for k, (n, us) in sorted(ops.items(), key=lambda kv: -kv[1][1]):
        print("    %5.1f x %8.4f ms  %s" % (n / runs, us / n / 1e3, k[:100]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--se", action="store_true",
                    help="the single-end corpus (2 x --pairs reads)")
    ap.add_argument("--pairs", type=int, default=320_000)
    ap.add_argument("--workers", default="8,1",
                    help="comma-separated worker counts, one profile each")
    ap.add_argument("--stack", action="store_true",
                    help="record each op's Python stack and name the line "
                    "of the port that ran each range's torch kernels")
    ap.add_argument("--tree", default=ROOT,
                    help="the checkout whose repaq_tpu_torch and "
                         "chip_smoke.py are profiled (default: this one)")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_pe: torch sees no CUDA device")
        return 2
    import chip_smoke
    from repaq_tpu_torch import cli
    from repaq_tpu_torch.codec.device_engine import DeviceEngine

    work = os.path.join(ROOT, ".smoke", "profile")
    os.makedirs(work, exist_ok=True)
    if args.se:
        fqs = [os.path.join(work, "r1.fq")]
        size = chip_smoke.make_corpus(fqs, 2 * args.pairs, 150, seed=96)
    else:
        fqs = [os.path.join(work, "r%d.fq" % m) for m in (1, 2)]
        size = chip_smoke.make_pe_corpus(fqs, args.pairs, 150, seed=97)
    rfq = os.path.join(work, "out.rfq")
    pe = len(fqs) == 2
    ins = ["-i", fqs[0]] + (["-I", fqs[1]] if pe else [])
    outs = ["-o", fqs[0] + ".b"] + (["-O", fqs[1] + ".b"] if pe else [])
    eng = DeviceEngine("cuda:0")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    print("card: %s; corpus %d FASTQ bytes; tree %s"
          % (chip_smoke.card_line(), size, tree))
    for workers in args.workers.split(","):
        w = ["-w", workers, "--engine", "device"]
        enc = ["-c", *ins, "-o", rfq, "-k", "12000", *w]
        dec = ["-d", "-i", rfq, *outs, *w]
        for argv in (enc, dec):  # cold: torch's lazy setup, the build
            if cli.main(argv, engine=eng.config()):
                raise SystemExit("the CLI failed: %s" % argv)
        for label, argv in (("encode", enc), ("decode", dec)):
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts,
                                        record_shapes=True,
                                        with_stack=args.stack) as prof:
                t0 = time.perf_counter()
                if cli.main(argv, engine=eng.config()):
                    raise SystemExit("the CLI failed: %s" % argv)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            report("%s, %s workers (%.1f MB/s)"
                   % (label, workers, size / 1e6 / wall), prof, wall)
    stats_report(eng, fqs[0])
    print("engine stats %s" % eng.stats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
