#!/usr/bin/env python3
"""The dense kNN and DGCNN kernels (rows 1, 3, 8 and 10 of PERF.md:
`dgcnn_eval`, `graph_stage1`, `knn`, `dgcnn_edges`) in one or more trees of
this repository, timed on one card in the order given.

    python3 scripts/dense_k_ab.py _parent . . _parent

Each tree runs in a process of its own with its own package and kernels. It
builds `csrc/dgcnn_eval.cu`, `csrc/knn.cu` and `csrc/graph_stage1.cu` (one
`nvcc -Xptxas -v` each, together) and records ptxas's registers and spill
bytes of every `__global__`, then times each kernel (CUDA events, the least
of three rounds of ten calls) at k = 20, the ModelNet graph, and at the
k above 32 where the tree's kernels take them: row 1 at 2B = 48 clouds of
717 (bf16 and float32), row 3 at 24 of 717 (bf16 and float32), row 8 at 48
of 1433, row 10 at 8 clouds of 4,096 over a seeded random graph (bf16 and
float32). Each call is also held against its plain version once (indices
identical, the largest output difference printed) and relaunched bit-equal.
The same seeded inputs go to every tree.

Prints one JSON line a tree, a table of the registers and spills of the
kernels both trees compiled where they differ, then the card's name and
power limit. Needs one CUDA device and nvcc.
"""
import json
import os
import sys

from ab_trees import build_ptxas, cuda_ms, main

SOURCES = ("dgcnn_eval", "knn", "graph_stage1")
KS = (20, 33, 40, 64)
B, N, N_LARGE, EMB = 24, 717, 1433, 512


def one(tree):
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from ogmm_tpu_torch.ops import common, cuda_dgcnn, cuda_dgcnn_train, cuda_knn, dispatch

    built, build_s = build_ptxas(dispatch, SOURCES)
    out = {"tree": tree, "build_s": build_s,
           "ptxas": {kern: v for lib in built.values() for kern, v in lib["kernels"].items()}}
    dev = torch.device("cuda")

    def tensor(a):
        return torch.tensor(a, device=dev)

    def weights(rs):
        dims = [(6, 64), (64, 64), (64, 128), (128, 256), (512, EMB)]
        ws = [tensor(rs.randn(*d).astype(np.float32) / np.sqrt(d[0])) for d in dims]
        aff = [(tensor(rs.uniform(0.5, 1.5, d[1]).astype(np.float32)),
                tensor(rs.uniform(-0.1, 0.1, d[1]).astype(np.float32))) for d in dims]
        return ws, aff

    def record(key, fn, check):
        err = check()
        a, b = fn(), fn()
        same = all(torch.equal(x, y) for x, y in zip(a, b)) if isinstance(a, tuple) \
            else torch.equal(a, b)
        ms, rounds = cuda_ms(fn)
        out[key] = {"ms": ms, "rounds_ms": rounds, "max_abs_err": err,
                    "relaunch_bit_equal": same}
        print(f"{os.path.basename(tree) or tree} {key}: {ms:.4f} ms "
              f"{[round(r, 4) for r in rounds]}, err {err:.3g}, relaunch equal {same}",
              file=sys.stderr)

    for k in KS:
        if k > 32 and not cuda_dgcnn_train.graph_takes(k, N):
            continue                          # a tree whose kernels stop at 32
        rs = np.random.RandomState(k)
        x48 = tensor(rs.randn(2 * B, N, 3).astype(np.float32) * 0.3)
        ws, aff = weights(rs)
        for dt, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            def check_eval(dt=dt):
                graph = torch.empty(2 * B, N, k, dtype=torch.int32, device=dev)
                o, al = cuda_dgcnn._dgcnn_eval_cuda(x48, ws, aff, k, dt, 5, idx=graph)
                r, ral = cuda_dgcnn.dgcnn_eval_reference(x48, ws, aff, k, dt, 5)
                assert torch.equal(graph.long(), cuda_knn.knn_reference(x48, x48, k))
                return max((o.float() - r.float()).abs().max().item(),
                           (al - ral).abs().max().item())
            record(f"dgcnn_eval k={k} {name}",
                   lambda dt=dt: cuda_dgcnn.dgcnn_eval(x48, ws, aff, k, dt, 5), check_eval)
            x24 = x48[:B].contiguous()

            def check_graph(dt=dt):
                got = cuda_dgcnn_train.graph_stage1(x24, ws[0], k, dt, 5)
                want = cuda_dgcnn_train.graph_stage1_reference(x24, ws[0], k, dt, 5)
                assert torch.equal(got[2], want[2]) and torch.equal(got[1], want[1])
                return max((got[0].float() - want[0].float()).abs().max().item(),
                           (got[3] - want[3]).abs().max().item())
            record(f"graph_stage1 k={k} {name}",
                   lambda dt=dt: cuda_dgcnn_train.graph_stage1(x24, ws[0], k, dt, 5),
                   check_graph)
            xe = tensor(rs.randn(8, 4096, 3).astype(np.float32) * 0.3)
            nbr = common.gather_neighbors(xe, tensor(rs.randint(0, 4096, (8, 4096, k))))

            def check_edges(dt=dt):
                o = cuda_dgcnn.dgcnn_edges(xe, nbr, ws, aff, k, dt)
                r = cuda_dgcnn.dgcnn_edges_reference(xe, nbr, ws, aff, k, dt)
                return (o.float() - r.float()).abs().max().item()
            record(f"dgcnn_edges k={k} {name}",
                   lambda dt=dt: cuda_dgcnn.dgcnn_edges(xe, nbr, ws, aff, k, dt), check_edges)
        xl = tensor(rs.randn(2 * B, N_LARGE, 3).astype(np.float32) * 0.3)

        def check_knn():
            assert torch.equal(cuda_knn.knn(xl, xl, k), cuda_knn.knn_reference(xl, xl, k))
            return 0.0
        record(f"knn k={k}", lambda: cuda_knn.knn(xl, xl, k), check_knn)
    print(json.dumps(out))


def compare_ptxas(runs):
    """The registers and spills of the kernels every distinct tree compiled,
    where two trees differ."""
    first = {}
    for run in runs:
        first.setdefault(run["tree"], run["ptxas"])
    trees = list(first)
    names = set.intersection(*(set(p) for p in first.values()))
    differ = {n: [first[t][n] for t in trees] for n in sorted(names)
              if len({tuple(first[t][n].values()) for t in trees}) > 1}
    print(json.dumps({"ptxas_trees": trees, "kernels_in_all": len(names),
                      "differ": differ}))


if __name__ == "__main__":
    main(__file__, __doc__, one, summary=compare_ptxas)
