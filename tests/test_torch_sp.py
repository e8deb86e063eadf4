"""Point-sharded serving of the port (`ogmm_tpu_torch/parallel/sp.py`,
`Registrar.sharded`) against the JAX package on the CPU: the counterpart of
every test of `tests/test_sp.py`, with its configuration and tolerances.

The port's ranks are processes joined by gloo (`parallel.launch.run_ranks`),
spawned once per world size (1, 2, 4) in a module fixture that runs every
case (`tests/torch_dist_cases.py:sp_cases`); each test compares one case.
The sharded forward is held against the JAX unsharded forward on the same
numpy inputs and weights and against JAX `make_sp_eval` on `sp_mesh(W)` of
the conftest's 8-device CPU mesh (jitted, about 4 s a compile)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ogmm_tpu.configs import mnet
from ogmm_tpu.core.procrustes import rigid_transform as jrigid
from ogmm_tpu.nn import GMMReg as JGMMReg
from ogmm_tpu.nn.layers import instance_norm as jinstance_norm
from ogmm_tpu.ops.common import index_points as jindex_points
from ogmm_tpu.ops.common import nn1 as jnn1
from ogmm_tpu.ops.sinkhorn import sinkhorn as jsinkhorn
from ogmm_tpu.parallel import make_sp_eval as jmake_sp_eval
from ogmm_tpu.parallel import sp_mesh as jsp_mesh
from ogmm_tpu_torch.parallel.launch import run_ranks
from ogmm_tpu_torch.weights import convert_variables

import torch_dist_cases as cases
from torch_port_util import to_plain

WORLDS = (1, 2, 4)
VARIANTS = ("f32", "f32_icp", "bf16")
NAMES = ("rot", "trans", "src_o", "tgt_o", "clu")
# tests/test_sp.py's tolerances: rot, trans, src_o, tgt_o, clu
TOL = (5e-5, 5e-5, 1e-4, 1e-4, 1e-3)
TOL_BF16 = {"rot": 5e-3, "src_o": 2e-2}


def _jcfg(**over):
    cfg = mnet()
    return cfg.replace(model=dataclasses.replace(cfg.model, **cases.SP_MODEL,
                                                 **over))


def _inputs():
    rng = np.random.RandomState(0)
    pair = lambda B, N: tuple(rng.randn(B, N, 3).astype(np.float32) * 0.3
                              for _ in range(2))
    x = {}
    x["src"], x["tgt"] = pair(2, 256)
    x["src1"], x["tgt1"] = pair(1, 192)
    x["src2"], x["tgt2"] = pair(1, 128)
    x["src255"] = pair(1, 255)[0]
    x["pts"] = rng.randn(2, 64, 5).astype(np.float32)
    x["idx"] = rng.randint(0, 64, size=(2, 7)).astype(np.int64)
    x["q"] = rng.randn(2, 9, 3).astype(np.float32)
    x["tq"] = rng.randn(2, 64, 3).astype(np.float32)
    x["feat"] = rng.randn(3, 64, 16).astype(np.float32)
    big = (rng.randn(1, 35000, 8).astype(np.float32)
           + 100.0 * np.abs(rng.randn(1, 1, 8)).astype(np.float32))
    x["big"] = np.ascontiguousarray(big[:, :34992])        # divisible by 4
    x["cost"] = np.abs(rng.randn(2, 64, 16)).astype(np.float32)
    logits = rng.randn(2, 64).astype(np.float32)
    x["p"] = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(
        np.float32)
    x["rs"] = rng.randn(2, 64, 3).astype(np.float32)
    x["rc"] = rng.randn(2, 64, 3).astype(np.float32)
    x["rw"] = np.abs(rng.rand(2, 64)).astype(np.float32)
    # ICP: a cloud, a rotated noisy copy, a start 3 degrees off
    src = (rng.rand(2, 256, 3) * [1.0, 1.0, 0.3]).astype(np.float32)
    from scipy.spatial.transform import Rotation
    rot = Rotation.from_rotvec(rng.uniform(-0.3, 0.3, (2, 3))).as_matrix()
    tr = rng.uniform(-0.1, 0.1, (2, 3))
    x["isrc"] = src
    x["itgt"] = (np.einsum("bij,bnj->bni", rot, src) + tr[:, None]
                 + 0.002 * rng.randn(2, 256, 3)).astype(np.float32)
    off = Rotation.from_rotvec(rng.uniform(-0.03, 0.03, (2, 3))).as_matrix()
    x["init"] = np.concatenate([off @ rot, tr[:, :, None]], -1).astype(np.float32)
    return x


@pytest.fixture(scope="module")
def jax_side():
    """The JAX weights (one jitted init), the port's state_dict from them,
    the JAX unsharded forward of each variant and the JAX primitives."""
    x = _inputs()
    src, tgt = jnp.asarray(x["src"]), jnp.asarray(x["tgt"])
    cfg = _jcfg()
    model = JGMMReg(cfg=cfg.model)
    v = jax.jit(lambda a, b: model.init({"params": jax.random.PRNGKey(0)},
                                        a, b, train=False))(src, tgt)
    cfgs = {"f32": cfg, "f32_icp": cfg, "bf16": _jcfg(dtype="bfloat16")}
    ref = {}
    for name, c in cfgs.items():
        m = JGMMReg(cfg=c.model)
        f = jax.jit(lambda a, b, m=m, t=name == "f32_icp": m.apply(
            v, a, b, train=False, is_test=t))
        ref[name] = [np.asarray(o) for o in f(src, tgt)]
    j = lambda k: jnp.asarray(x[k])
    ref["index_points_sp"] = np.asarray(jindex_points(j("pts"), j("idx")))
    ref["nn1_sp"] = [np.asarray(o) for o in jnn1(j("q"), j("tq"))]
    ref["instance_norm"] = np.asarray(jinstance_norm(j("feat")))
    ref["instance_norm_large"] = np.asarray(jinstance_norm(j("big")))
    g, loss = jsinkhorn(j("cost"), p=j("p"), max_iter=8)
    ref["sinkhorn"] = [np.asarray(g), float(loss)]
    ref["rigid"] = [np.asarray(o) for o in jrigid(j("rs"), j("rc"), j("rw"))]
    state = {k: t.numpy() for k, t in
             convert_variables(to_plain(v)).items()}
    return dict(x=x, v=v, cfgs=cfgs, ref=ref, state=state, jsp={})


def _jax_sp(jax_side, name, world):
    """JAX make_sp_eval of a variant on sp_mesh(world), cached."""
    key = (name, world)
    if key not in jax_side["jsp"]:
        x = jax_side["x"]
        fn = jmake_sp_eval(jax_side["v"], jax_side["cfgs"][name],
                           jsp_mesh(world), is_test=name == "f32_icp")
        jax_side["jsp"][key] = [np.asarray(o) for o in fn(
            jnp.asarray(x["src"]), jnp.asarray(x["tgt"]))]
    return jax_side["jsp"][key]


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def ranks(request, jax_side):
    world = request.param
    res = run_ranks(cases.sp_cases, world, args=(jax_side["state"],
                                                 jax_side["x"]), timeout=240)
    return world, res


def _close(got, want, tols, dtype_name):
    if dtype_name == "bf16":
        np.testing.assert_allclose(got[0], want[0], atol=TOL_BF16["rot"])
        np.testing.assert_allclose(got[2], want[2], atol=TOL_BF16["src_o"])
        return
    for name, a, b, tol in zip(NAMES, got, want, tols):
        np.testing.assert_allclose(a, b, atol=tol, err_msg=name)


@pytest.mark.parametrize("variant", VARIANTS)
def test_sp_matches_jax_unsharded(ranks, jax_side, variant):
    """The counterpart of `test_sp_matches_unsharded` (is_test False and
    True) and `test_sp_bf16_body`: the port's sharded forward against the
    JAX unsharded forward, every rank the same answer."""
    world, res = ranks
    got = res[0][f"fwd_{variant}"]
    _close(got, jax_side["ref"][variant], TOL, variant)
    for r in res[1:]:
        for a, b in zip(r[f"fwd_{variant}"], got):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("variant", VARIANTS)
def test_sp_matches_sharded_reference(ranks, jax_side, variant):
    """Against JAX `make_sp_eval` on `sp_mesh(W)` at W >= 2; at W = 1
    against the port's own unsharded forward in float32 (the other graph
    route: the cross graph against the kernel graph). The port's unsharded
    bf16 body takes the dense overlap head, which rounds at other places
    than the streamed head of the sharded forward (5.3e-3 apart in the
    rotation, above the bf16 bar), so bf16 at W = 1 meets the JAX
    unsharded forward, which JAX's sp_mesh(1) forward equals within
    tests/test_sp.py's bars."""
    world, res = ranks
    if world > 1:
        want = _jax_sp(jax_side, variant, world)
    elif variant == "bf16":
        want = jax_side["ref"]["bf16"]
    else:
        want = res[0][f"unsharded_{variant}"]
    _close(res[0][f"fwd_{variant}"], want, TOL, variant)


def test_sp_mesh_sizes(ranks):
    """B = 1, N = 192 at every world size: rot against the port's unsharded
    forward (tests/test_sp.py's 5e-5)."""
    _, res = ranks
    np.testing.assert_allclose(res[0]["mesh"], res[0]["mesh_unsharded"],
                               atol=5e-5)


def test_registrar_sharded_matches_call(ranks, jax_side):
    """`Registrar.sharded(refine=False)` returns what the port's own
    unsharded call returns (tests/test_sp.py's 1e-4)."""
    _, res = ranks
    x = jax_side["x"]
    reg = cases.sp_registrar(jax_side["state"])
    ref = reg(x["src2"], x["tgt2"], refine=False)
    for a, b in zip(res[0]["registrar"], ref):
        np.testing.assert_allclose(a, b.numpy(), atol=1e-4)


def test_index_points_sp(ranks, jax_side):
    _, res = ranks
    np.testing.assert_array_equal(res[0]["index_points_sp"],
                                  jax_side["ref"]["index_points_sp"])


def test_nn1_sp(ranks, jax_side):
    """Indices equal to JAX's; the distances bit for bit those of the port's
    unsharded `nn1` (which forms them in the fixed order its kernels use:
    JAX's CPU product differs from it in the last bit, 1e-5 relative)."""
    from ogmm_tpu_torch.ops.common import nn1
    _, res = ranks
    (d, i), (d_ref, i_ref) = res[0]["nn1_sp"], jax_side["ref"]["nn1_sp"]
    x = jax_side["x"]
    d_port = nn1(torch.from_numpy(x["q"]), torch.from_numpy(x["tq"]))[0]
    np.testing.assert_array_equal(i, i_ref)
    np.testing.assert_array_equal(d, d_port.numpy())
    np.testing.assert_allclose(d, d_ref, rtol=1e-5)


def test_nn1_sp_ties_go_to_the_lowest_global_index():
    """Equal distances on two processes: the lower process's (and so the
    lower global) index wins, as the JAX argmin over the gathered pairs."""
    res = run_ranks(cases.sp_ties_case, 2, timeout=120)
    assert res[0] == res[1] == [0, 3]


def test_instance_norm_sp(ranks, jax_side):
    _, res = ranks
    np.testing.assert_allclose(res[0]["instance_norm"],
                               jax_side["ref"]["instance_norm"], atol=1e-5)


def test_instance_norm_sp_large_n_large_mean(ranks, jax_side):
    """N = 34,992 rows with a large common offset: the two-pass sharded
    moments stay at tests/test_sp.py's 1e-4 (the single-pass form is 0.8%
    off on the variance there)."""
    _, res = ranks
    np.testing.assert_allclose(res[0]["instance_norm_large"],
                               jax_side["ref"]["instance_norm_large"],
                               atol=1e-4)


def test_sinkhorn_sharded_rows(ranks, jax_side):
    _, res = ranks
    (g, loss), (g_ref, l_ref) = res[0]["sinkhorn"], jax_side["ref"]["sinkhorn"]
    np.testing.assert_allclose(g, g_ref, atol=1e-5)
    np.testing.assert_allclose(float(loss), l_ref, rtol=1e-5)


def test_rigid_transform_sharded(ranks, jax_side):
    _, res = ranks
    for a, b in zip(res[0]["rigid"], jax_side["ref"]["rigid"]):
        np.testing.assert_allclose(a, b, atol=1e-5)


@pytest.mark.parametrize("kind", ["icp_p2p", "icp_plane"])
def test_icp_sharded_matches_unsharded(ranks, kind):
    """Point-to-point and point-to-plane ICP over local source rows against
    the whole target: the poses of the unsharded loop (the moments summed
    in another order)."""
    _, res = ranks
    for a, b in zip(res[0][kind], res[0][f"{kind}_plain"]):
        np.testing.assert_allclose(a, b, atol=1e-5)


@pytest.mark.parametrize("case,exc,match", [
    ("undivisible", "ValueError", "divide"),
    ("mismatched", "ValueError", "same point count"),
    ("training", "ValueError", "eval/serving"),
    ("em_kernel", "ValueError", "em_kernel"),
    ("init_nodes", "ValueError", "init_nodes"),
    ("icp_kernel", "ValueError", "use_kernel"),
    ("sinkhorn_p", "ValueError", "row marginal"),
])
def test_sp_refusals(ranks, case, exc, match):
    """The JAX package's refusals: points not divisible by W (none at
    W = 1), tgt N unlike src N, training, a forced EM kernel, the
    clustering without initial centres, the whole-loop ICP kernel and a
    Sinkhorn without a row marginal under a group."""
    world, res = ranks
    got = res[0]["refusals"][case]
    if case == "undivisible" and world == 1:
        assert got is None
        return
    assert got is not None and got[0] == exc and match in got[1], got


def test_deepgmr_has_no_sharded_forward():
    from ogmm_tpu_torch import configs
    from ogmm_tpu_torch.api import Registrar
    reg = Registrar(configs.mnet(model=configs.ModelConfig(**cases.SP_MODEL))
                    .replace(model_name="DeepGMR"), device="cpu")
    with pytest.raises(NotImplementedError, match="GMMReg"):
        reg.sharded()


def test_sp_mesh_needs_a_process_group():
    from ogmm_tpu_torch.parallel import sp_mesh
    with pytest.raises(RuntimeError, match="torch.distributed"):
        sp_mesh()
