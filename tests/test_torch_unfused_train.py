"""One train step of the port with `dgcnn_fused_train=False` at B=4, N=200
against the JAX package's naive route on the CPU (`pallas_override(False)`):
the DGCNN builds its own kNN graph and takes the unfused stage chain, the
position encoding takes its angle kernel's route (the plain version here),
and the loss agrees to 1e-4 and every gradient to 2e-4 relative, the bars
of tests/test_torch_train.py (whose batch of 4 this step keeps: at B=2 the
overlap heads' gradients are float32-conditioned to ~2e-3 on either DGCNN
route), with the eager JAX gradients and shared graph of
tests/test_torch_large_n.py."""
from test_torch_large_n import (_batch, _check_step, _configs, _jax_step,
                                same_graph)  # noqa: F401  (a fixture)

from ogmm_tpu_torch.nn.gmmreg import GMMReg as TGMMReg
from ogmm_tpu_torch.nn.attention import angle_route
from ogmm_tpu_torch.nn.dgcnn import fused_route


def test_one_unfused_train_step_matches_jax(same_graph):
    jc, tc = _configs(dgcnn_fused_train=False)
    assert TGMMReg(tc.model).dgcnn.fused_train is False
    # the routes this step takes: the unfused DGCNN, the angle kernel
    assert not fused_route(200, tc.model.gnn_k, True, False, False)
    assert angle_route(200, tc.model.pos_k, False, False) == "kernel"
    batch = _batch(1, 4, 200)
    _, variables, jloss, jgrads, jstats = _jax_step(jc, batch, seed=1)
    _check_step(tc, variables, batch, jloss, jgrads, jstats)
