"""What the spawned ranks of `tests/test_torch_sp.py` and
`tests/test_torch_distributed.py` run.

Each function runs in a fresh process of `run_ranks` with the process group
initialised (gloo, CPU): `fn(rank, world, device, ...)`, returning numpy
arrays and plain values for the parent to compare. This module imports
neither JAX nor the JAX package (the ranks import the port only)."""
import dataclasses

import torch
import torch.distributed as dist

# tests/test_sp.py's small configuration
SP_MODEL = dict(emb_dims=64, n_clusters=16, km_clusters=16, num_heads=2,
                gnn_k=8, pos_k=4, em_iters=3, sinkhorn_iters=5, icp_iters=3)
# tests/test_torch_train.py's
DP_MODEL = dict(emb_dims=32, n_clusters=8, km_clusters=8, num_heads=2,
                gnn_k=8, pos_k=4, em_iters=2, sinkhorn_iters=3, icp_iters=2)
DP_TRAIN = dict(n_keypoints=16)


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).numpy()
    return x


def _refusal(fn):
    try:
        fn()
    except Exception as e:                      # noqa: BLE001 - reported
        return type(e).__name__, str(e)
    return None


def sp_cfg(**over):
    from ogmm_tpu_torch import configs
    return configs.mnet(model=configs.ModelConfig(**{**SP_MODEL, **over}))


def sp_registrar(state, **over):
    from ogmm_tpu_torch.api import Registrar
    sd = {k: torch.from_numpy(v) for k, v in state.items()}
    return Registrar(sp_cfg(**over), state_dict=sd, device="cpu")


def sp_cases(rank, world, device, state, x):
    """The point-sharded forward and its primitives at this world size.
    `state` is the port's state_dict (numpy), `x` a dict of numpy inputs."""
    from ogmm_tpu_torch.core.procrustes import rigid_transform
    from ogmm_tpu_torch.nn.layers import instance_norm
    from ogmm_tpu_torch.ops.common import index_points_sp, nn1_sp
    from ogmm_tpu_torch.ops.gmm import wkeans_plus
    from ogmm_tpu_torch.ops.icp import icp_point_to_plane, icp_point_to_point
    from ogmm_tpu_torch.ops.sinkhorn import sinkhorn
    from ogmm_tpu_torch.parallel import make_sp_eval, sp_mesh
    from ogmm_tpu_torch.parallel.comm import all_gather, row_range

    group = sp_mesh()
    t = {k: torch.from_numpy(v) for k, v in x.items()}

    def rows(a):
        lo, hi = row_range(a.shape[1], group)
        return a[:, lo:hi]

    out = {}

    # the forward: float32 with and without ICP, the bf16 body
    for name, over, is_test in (("f32", {}, False), ("f32_icp", {}, True),
                                ("bf16", {"dtype": "bfloat16"}, False)):
        reg = sp_registrar(state, **over)
        fn = make_sp_eval(reg.model, reg.cfg, group, is_test=is_test)
        out[f"fwd_{name}"] = [_np(o) for o in fn(t["src"], t["tgt"])]
        with torch.no_grad():
            out[f"unsharded_{name}"] = [_np(o) for o in reg.model(
                t["src"], t["tgt"], refine=is_test)]
    reg = sp_registrar(state)
    out["mesh"] = _np(make_sp_eval(reg.model, reg.cfg, group)(
        t["src1"], t["tgt1"])[0])
    with torch.no_grad():
        out["mesh_unsharded"] = _np(reg.model(t["src1"], t["tgt1"])[0])
    out["registrar"] = [_np(o) for o in reg.sharded(refine=False)(
        t["src2"], t["tgt2"])]

    # the primitives, each on this rank's rows of the inputs
    out["index_points_sp"] = _np(index_points_sp(rows(t["pts"]), t["idx"], group))
    out["nn1_sp"] = [_np(o) for o in nn1_sp(t["q"], rows(t["tq"]), group)]
    out["instance_norm"] = _np(all_gather(
        instance_norm(rows(t["feat"]), group=group), group, 1))
    out["instance_norm_large"] = _np(all_gather(
        instance_norm(rows(t["big"]), group=group), group, 1))
    g, loss = sinkhorn(rows(t["cost"]), p=rows(t["p"]), max_iter=8, group=group)
    out["sinkhorn"] = [_np(all_gather(g, group, 1)), _np(loss)]
    out["rigid"] = [_np(o) for o in rigid_transform(
        rows(t["rs"]), rows(t["rc"]), rows(t["rw"]), group=group)]
    init = t["init"]
    out["icp_p2p"] = [_np(o) for o in icp_point_to_point(
        rows(t["isrc"]), t["itgt"], init, 0.07, max_iter=5, group=group)]
    out["icp_p2p_plain"] = [_np(o) for o in icp_point_to_point(
        t["isrc"], t["itgt"], init, 0.07, max_iter=5)]
    out["icp_plane"] = [_np(o) for o in icp_point_to_plane(
        rows(t["isrc"]), t["itgt"], init, 0.07, max_iter=5, group=group)]
    out["icp_plane_plain"] = [_np(o) for o in icp_point_to_plane(
        t["isrc"], t["itgt"], init, 0.07, max_iter=5)]

    # the refusals
    fwd = make_sp_eval(reg.model, reg.cfg, group)
    sp_model = reg.model.__class__(reg.cfg.model, sp_group=group)
    xyz, feats = rows(t["src"]), torch.zeros(2, t["src"].shape[1] // world, 8)
    o = torch.ones(2, xyz.shape[1])
    nodes = t["src"][:, :4]
    out["refusals"] = {
        "undivisible": _refusal(lambda: fwd(t["src255"], t["src255"])),
        "mismatched": _refusal(lambda: fwd(t["src"], t["src"][:, :128])),
        "training": _refusal(lambda: sp_model.train()(
            rows(t["src"]), rows(t["tgt"]), full_src=t["src"],
            full_tgt=t["tgt"])),
        "em_kernel": _refusal(lambda: wkeans_plus(
            xyz, feats, o, 4, init_nodes=nodes, em_kernel=True, group=group)),
        "init_nodes": _refusal(lambda: wkeans_plus(xyz, feats, o, 4,
                                                   group=group)),
        "icp_kernel": _refusal(lambda: icp_point_to_point(
            rows(t["isrc"]), t["itgt"], init, 0.07, use_kernel=True,
            group=group)),
        "sinkhorn_p": _refusal(lambda: sinkhorn(rows(t["cost"]), group=group)),
    }
    return out


def sp_ties_case(rank, world, device):
    """`nn1_sp` where the nearest point of the first query lies on both
    ranks (global rows 0 and 4); the second's is global row 3 alone."""
    from ogmm_tpu_torch.ops.common import nn1_sp
    tgt = torch.tensor([[[0.0, 0, 0], [5, 5, 5], [6, 6, 6], [1, 1, 1],
                         [0, 0, 0], [7, 7, 7], [8, 8, 8], [9, 9, 9]]])
    q = torch.tensor([[[0.0, 0, 0], [1, 1, 1.1]]])
    part = tgt[:, rank * 4:rank * 4 + 4]
    return nn1_sp(q, part, dist.group.WORLD)[1][0].tolist()


# ------------------------------------------------------- data parallelism

def dp_cfg(**over):
    from ogmm_tpu_torch import configs
    cfg = configs.mnet(model=configs.ModelConfig(**{**DP_MODEL, **over}))
    return cfg.replace(train=dataclasses.replace(cfg.train, **DP_TRAIN))


def dp_step(state_dict, batch, group, seed=None, with_generator=False, **over):
    """One train step of the port from `state_dict` (numpy) on the global
    `batch` under `group`: (metrics, gradients (averaged), the new
    state_dict), numpy."""
    from ogmm_tpu_torch.train import create_train_state, make_train_step
    cfg = dp_cfg(**over)
    sd = {k: torch.from_numpy(v) for k, v in state_dict.items()}
    state = create_train_state(cfg, steps_per_epoch=10, device="cpu",
                               state_dict=sd, group=group, seed=seed)
    if not with_generator:
        state.generator = None           # anchors from index 0, as in JAX
    metrics = make_train_step(cfg)(state, batch)
    grads = {k: _np(p.grad) for k, p in state.model.named_parameters()
             if p.grad is not None}
    return ({k: _np(v) for k, v in metrics.items()}, grads,
            {k: _np(v) for k, v in state.model.state_dict().items()})


def dp_cases(rank, world, device, state_dict, batch, cli_argv):
    """The data-parallel step in each case the tests compare, the refusal
    of the backward kernels under the group, and the CLI with --multihost
    (process 0 alone holds the checkpointer)."""
    from ogmm_tpu_torch.ops import dgcnn_train
    from ogmm_tpu_torch.train import cli
    group = dist.group.WORLD
    out = {"fused": dp_step(state_dict, batch, group),
           "unfused": dp_step(state_dict, batch, group,
                              dgcnn_fused_train=False),
           "generator": dp_step(state_dict, batch, group, seed=5,
                                with_generator=True)}
    dgcnn_train.BWD_KERNELS = True
    try:
        out["bwd_kernels"] = _refusal(lambda: dp_step(state_dict, batch, group))
    finally:
        dgcnn_train.BWD_KERNELS = False
    trainer = cli.main(cli_argv)
    out["cli"] = {"step": trainer.state.step,
                  "writer": trainer.checkpointer is not None,
                  "loss": trainer.history[-1]["train"]["loss"],
                  "val_loss": trainer.history[-1]["val"]["loss"],
                  "params": {k: _np(v) for k, v in
                             trainer.state.model.state_dict().items()}}
    return out


# ------------------------------------------------------- the build lock

def build_case(rank, world, device, which, build_dir):
    """Point the build directory at `build_dir`, wait for every process,
    then build and load the kernel library of `knn` (`which` = 'kernels')
    or the host library ('host') at once; returns the value of the fake
    library's one function."""
    import ctypes
    from pathlib import Path
    if which == "kernels":
        from ogmm_tpu_torch.ops import dispatch as mod
        mod.BUILD_DIR = Path(build_dir)
        build = lambda: mod.build_kernels(("knn",))["knn"]
    else:
        import ogmm_tpu_torch.native as mod
        mod.BUILD_DIR = Path(build_dir)
        build = mod.build
    dist.barrier()
    return ctypes.CDLL(str(build())).ogmm_fake()
