#!/usr/bin/env python3
"""The float32 forms of `bwd_stage`, `bwd_edge` and `pointmlp` in one or
more trees of this repository, timed on one card in the order given.

    python3 scripts/f32_forms_ab.py _parent . . _parent

Each tree runs in a process of its own with its own package, kernels and
`chip_smoke.py` (whose `bwd_calls`, `cuda_ms` and `device_trace` it uses):

  bwd_stage  the three stage calls (stages 4, 3, 2) of one cloud side's
             float32 DGCNN backward at B=24, N=717 (`chip_smoke.bwd_calls`):
             ms of the three (CUDA events), the device ms of each kernel
             they launch (torch.profiler), the largest error of each output
             against the plain version as a share of max|plain|, a relaunch
             bit-equal
  bwd_edge   the edge call of that backward (stage 1, dW_1, dq, dscat):
             the same figures
  pointmlp   the attention MLP's float32 call (48, 717, 1024 -> 1024 ->
             512): ms, device ms of each kernel, max|kernel - plain|

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
    from ogmm_tpu_torch.ops import cuda_mlp, dispatch

    dispatch.build_kernels()
    out = {"tree": tree}

    def kernels_ms(fn, reps):
        return {evt.key[:60]: round(evt.device_time_total / 1e3 / reps, 4)
                for evt in cs.device_trace(fn, reps) if evt.device_time_total > 0}

    every = cs.bwd_calls(np.random.RandomState(0), torch.float32)
    for name in ("bwd_stage", "bwd_edge"):
        calls = [c for c in every if c[0] == name]
        kern, plain, _ = cs.BWD[name]

        def run():
            return [kern(*a, **kw) for _, a, kw in calls]
        got, again = run(), run()
        torch.cuda.synchronize()
        errs, same = [], True
        for g3, a3, (_, a, kw) in zip(got, again, calls):
            ref = plain(*a, **kw)
            for g, g2, r in zip(g3, a3, ref):
                same = same and torch.equal(g, g2)
                errs.append((g - r).abs().max().item() / r.abs().max().item())
        out[name] = {"ms": cs.cuda_ms(run, 10), "device_ms": kernels_ms(run, 5),
                     "rel_err_max": max(errs), "relaunch_bit_equal": same}

    rs = np.random.RandomState(9)
    w = lambda *sh: torch.tensor(rs.randn(*sh).astype(np.float32) / np.sqrt(sh[-1]),
                                 device="cuda")
    x = torch.tensor(rs.randn(48, 717, 1024).astype(np.float32), device="cuda")
    args = (x, w(1024, 1024), w(1024) * 0.3, w(512, 1024), w(512) * 0.3, torch.float32)
    mlp = lambda: cuda_mlp.pointmlp_eval(*args)
    err = (mlp() - cuda_mlp.pointmlp_eval_reference(*args)).abs().max().item()
    out["pointmlp"] = {"ms": cs.cuda_ms(mlp, 10), "device_ms": kernels_ms(mlp, 5),
                       "max_abs_err": err}
    print(json.dumps(out))


if __name__ == "__main__":
    main(__file__, __doc__, one)
