#!/usr/bin/env python3
"""The Sinkhorn-EM kernel (`sinkhorn_em`, 10 EM x 10 Sinkhorn trips) in one
or more trees of this repository, timed on one card in the order given.

    python3 scripts/em_ab.py _parent . . _parent

Each tree runs in a process of its own with its own package and kernels. It
builds `csrc/sinkhorn_em.cu` alone (seconds; with `--ptxas`, printing each
instance's registers and spills), then times the kernel (CUDA events, the
least of three rounds of ten calls) at the shapes up to K = 256, the
request's (48, 717, 128) first, and at the shapes above K = 256 where the
tree's kernel takes them; one trip against the plain version and a relaunch
bit-equal for each. The same seeded inputs go to every tree.

Prints one JSON line a tree, then the card's name and power limit. Needs one
CUDA device and nvcc.
"""
import json
import os
import sys
import time

from ab_trees import cuda_ms, main

# (clouds, N, K): the request's 2B = 48 clouds and the training step's 24 at
# K = 128, N = 1433, clusters of 16 blocks (K <= 256); then K above 256
SHAPES = ((48, 717, 128), (24, 717, 128), (48, 1433, 128), (8, 5734, 128),
          (8, 4096, 128), (8, 2867, 256))
WIDE = ((48, 717, 512), (24, 1433, 512), (8, 2000, 257), (8, 857, 856),
        (8, 717, 1023))


def one(tree, ptxas):
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from ogmm_tpu_torch.ops import cuda_em, dispatch
    from ogmm_tpu_torch.ops.common import index_points
    from ogmm_tpu_torch.ops.fps import farthest_point_sample

    t0 = time.perf_counter()
    dispatch.build_kernels(("sinkhorn_em",), verbose=ptxas)
    out = {"tree": tree, "build_s": time.perf_counter() - t0}

    for clouds, n, k in SHAPES + WIDE:
        if not cuda_em.kernel_takes(n, k):
            continue
        rs = np.random.RandomState(n * 7 + k)
        xyz = torch.tensor(rs.randn(clouds, n, 3).astype(np.float32) * 0.3, device="cuda")
        o = torch.tensor(rs.rand(clouds, n).astype(np.float32), device="cuda")
        o = o / o.sum(-1, keepdim=True)
        n0 = index_points(xyz, farthest_point_sample(xyz, k, is_center=True))
        got = cuda_em.sinkhorn_em(xyz, o, n0, iters=1)
        want = cuda_em.sinkhorn_em_reference(xyz, o, n0, iters=1)
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        ten = lambda: cuda_em.sinkhorn_em(xyz, o, n0, iters=10)
        same = all(torch.equal(a, b) for a, b in zip(ten(), ten()))
        ms, rounds = cuda_ms(ten)
        out[f"{clouds},{n},{k}"] = {
            "ms": ms, "rounds_ms": rounds, "cluster": cuda_em.cluster_size(n, k),
            "clusters_at_once": cuda_em.max_clusters(n, k),
            "smem_bytes": cuda_em.smem_bytes(n, k, cuda_em.cluster_size(n, k)),
            "max_abs_err_1_trip": err, "relaunch_bit_equal": same}
        print(f"{os.path.basename(tree) or tree} ({clouds}, {n}, {k}): {ms:.4f} ms "
              f"{[round(r, 4) for r in rounds]}, cluster {cuda_em.cluster_size(n, k)}, "
              f"err {err:.3g}, relaunch equal {same}", file=sys.stderr)
    print(json.dumps(out))


if __name__ == "__main__":
    main(__file__, __doc__, one, flags=("--ptxas",))
