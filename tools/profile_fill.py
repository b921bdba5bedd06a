#!/usr/bin/env python3
"""What the decode's run writes cost on one NVIDIA GPU: the scatters that
``kernels.fill_runs`` replaced, and why they cost what they did.

    python3 tools/profile_fill.py [--kernel [--tree DIR]]

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
The last line of output is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", action="store_true",
                    help="also time kernels.fill_runs in turns with the "
                         "parent's composition")
    ap.add_argument("--tree", default=ROOT,
                    help="checkout whose repaq_tpu_torch --kernel times")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("profile_fill: torch sees no CUDA device")
        return 2
    import chip_smoke as cs

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
