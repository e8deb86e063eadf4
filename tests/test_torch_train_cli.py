"""The port's training command line (`python -m ogmm_tpu_torch.train`,
`ogmm_tpu_torch/train/cli.py`) end to end on the CPU, as a user starts it:
argv -> Config -> the synthetic ModelNet loaders -> Trainer.fit -> eval ->
checkpoint -> weights the JAX package reads back."""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from ogmm_tpu.train.checkpoint import load_weights as jload_weights
from ogmm_tpu_torch.train import cli

TINY = ["--emb_dims", "32", "--n_clusters", "8", "--km_clusters", "8",
        "--num_heads", "2", "--gnn_k", "8"]
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(tmp_path, *extra):
    return cli.main(["--device", "cpu", "--dataset", "synthetic",
                     "--root", "synthetic:24", "--n_points", "64", *TINY,
                     "--batch_size", "8", "--test_batch_size", "4",
                     "--epochs", "1", "--steps_per_epoch", "2",
                     "--model_path", str(tmp_path / "ckpt"), *extra])


def test_cli_trains_saves_and_exports_for_the_jax_package(tmp_path):
    npz = tmp_path / "weights.npz"
    trainer = _run(tmp_path, "--export_weights", str(npz))
    assert trainer.state.device.type == "cpu" and trainer.state.step == 2
    assert len(trainer.history) == 1
    rec = trainer.history[-1]
    assert np.isfinite(rec["train"]["loss"])
    assert np.isfinite(rec["val"]["loss"])              # the last epoch evals
    models = tmp_path / "ckpt" / "checkpoints" / "GMMReg" / "models"
    assert (models / "optim_model.pt").exists()
    saved = json.loads((models / "config.json").read_text())
    assert saved["model"]["emb_dims"] == 32
    assert saved["data"]["n_points"] == 64 and saved["data"]["dataset"] == "synthetic"
    assert (tmp_path / "ckpt" / "GMMReg" / "train.log").exists()

    variables, cfg = jload_weights(str(npz))
    assert cfg.model.emb_dims == 32 and cfg.data.n_points == 64
    assert set(variables) == {"params", "batch_stats"}
    w5 = variables["params"]["DGCNN_0"]["w5"]
    assert w5.shape == (512, 32)
    np.testing.assert_array_equal(
        w5, trainer.state.model.dgcnn.w5.detach().numpy())


def test_cli_eval_only_restores_the_checkpoint(tmp_path):
    first = _run(tmp_path)
    again = _run(tmp_path, "--eval_only")
    assert again.state.step == first.state.step == 2     # restored, not trained
    for (k, a), b in zip(first.state.model.state_dict().items(),
                         again.state.model.state_dict().values()):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)
    assert again.history == []


@pytest.mark.parametrize("steps", [6, 4])
def test_cli_profile_dir_traces_steps_5_to_10(tmp_path, steps):
    """--profile_dir traces epoch 0's steps [5, 10) (the JAX trainer's
    window): a run of 6 steps writes the trace of step 5, closed where the
    epoch ends; a run of 4 steps never opens the window."""
    prof = tmp_path / "prof"
    trainer = cli.main(["--device", "cpu", "--dataset", "synthetic",
                        "--root", "synthetic:24", "--n_points", "32", *TINY,
                        "--batch_size", "2", "--test_batch_size", "2",
                        "--epochs", "1", "--steps_per_epoch", str(steps),
                        "--model_path", str(tmp_path / "ckpt"),
                        "--profile_dir", str(prof)])
    assert trainer.state.step == steps
    if steps < 6:
        assert not prof.exists()
        return
    files = sorted(os.listdir(prof))
    assert files == ["train_steps_5_6.pt.trace.json"]
    events = json.loads((prof / files[0]).read_text())["traceEvents"]
    ranges = [e for e in events if e.get("name") == "train"
              and e.get("cat") == "user_annotation"]
    assert len(ranges) == 1            # step 5, inside record_function("train")
    assert any(e.get("cat") == "cpu_op" for e in events)


@pytest.mark.parametrize("flags", [["--model", "DeepGMR"],
                                   ["--model", "DeepGMR",
                                    "--dataset", "modelnetcp"]])
def test_cli_trains_deepgmr(tmp_path, flags):
    """DeepGMR on the synthetic ModelNet crops (N = M) and on the crop pairs
    of modelnetcp (src cropped: N != M), two steps and an eval batch; its
    checkpoint goes under checkpoints/DeepGMR/."""
    trainer = _run(tmp_path, *flags)
    assert trainer.cfg.model_name == "DeepGMR" and trainer.state.step == 2
    rec = trainer.history[-1]
    assert np.isfinite(rec["train"]["loss"]) and np.isfinite(rec["val"]["loss"])
    assert (tmp_path / "ckpt" / "checkpoints" / "DeepGMR" / "models"
            / "optim_model.pt").exists()


def test_cli_refuses_gmmreg_on_unequal_clouds(tmp_path):
    """GMMReg's overlap head needs N = M; modelnetcp crops src only."""
    with pytest.raises(ValueError, match="equal point counts"):
        _run(tmp_path, "--dataset", "modelnetcp")


def test_module_entry_point_runs_the_cli():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-m", "ogmm_tpu_torch.train",
                          "--help"], capture_output=True,
                         text=True, cwd=ROOT, env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "--profile_dir" in res.stdout and "--multihost" in res.stdout
