#!/usr/bin/env python3
"""The three DGCNN backward kernels (rows 5-7: `bwd_reduce`, `bwd_stage`,
`bwd_edge`) in one or more trees of this repository, timed on one card in
the order given.

    python3 scripts/bwd_rows_ab.py _parent . . _parent

Each tree runs in a process of its own with its own package, kernels and
`chip_smoke.py` (whose `bwd_calls`, `cuda_ms` and `device_trace` it uses):
the five calls of one cloud side's DGCNN backward at B=24, N=717, k=20
(`chip_smoke.bwd_calls`), bf16 and float32; for each kernel the ms of its
calls of one backward (CUDA events over 20 rounds; rounds of the three
kernels in turns, three times, the least kept), the device ms of each
`__global__` they launch (torch.profiler), the largest error of each output
against the plain version as a share of max|plain|, and a relaunch
bit-equal.

Prints one JSON line a tree, then the card's name and power limit. Needs one
CUDA device and nvcc.
"""
import json
import os
import sys

from ab_trees import main


def one(tree):
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from ogmm_tpu_torch.ops import dispatch

    dispatch.build_kernels()
    out = {"tree": tree}

    def kernels_ms(fn, reps):
        return {evt.key[:60]: round(evt.device_time_total / 1e3 / reps, 4)
                for evt in cs.device_trace(fn, reps) if evt.device_time_total > 0}

    for dt, key in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        every = cs.bwd_calls(np.random.RandomState(0), dt)
        runs = {}
        for name in ("bwd_reduce", "bwd_stage", "bwd_edge"):
            calls = [c for c in every if c[0] == name]
            kern, plain, _ = cs.BWD[name]

            def run(calls=calls, kern=kern):
                return [kern(*a, **kw) for _, a, kw in calls]
            got, again = run(), run()
            torch.cuda.synchronize()
            errs, same = [], True
            for g3, a3, (_, a, kw) in zip(got, again, calls):
                ref = plain(*a, **kw)
                outs = [(g3, a3, ref)] if name == "bwd_reduce" else zip(g3, a3, ref)
                for g, g2, r in outs:
                    same = same and torch.equal(g, g2)
                    errs.append(((g.float() - r.float()).abs().max()
                                 / r.float().abs().max()).item())
            runs[name] = run
            out[f"{name}_{key}"] = {"rel_err_max": max(errs), "relaunch_bit_equal": same,
                                    "ms": []}
        for _ in range(3):
            for name, run in runs.items():
                out[f"{name}_{key}"]["ms"].append(cs.cuda_ms(run, 20))
        for name, run in runs.items():
            r = out[f"{name}_{key}"]
            r["ms_least"] = min(r["ms"])
            r["device_ms"] = kernels_ms(run, 10)
        del every
    print(json.dumps(out))


if __name__ == "__main__":
    main(__file__, __doc__, one)
