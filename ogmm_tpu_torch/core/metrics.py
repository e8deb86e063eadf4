"""Registration metrics of a batch, on the device, the definitions of the JAX
package's `ogmm_tpu/core/metrics.py`.

Recall counts a pair as correct when its mean absolute Euler error is below
1 degree and its mean absolute translation error below 0.1.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ogmm_tpu_torch.core import se3
from ogmm_tpu_torch.ops.common import nn1, nn1_both


def rotation_error(rot1: torch.Tensor, rot2: torch.Tensor) -> torch.Tensor:
    """Isotropic rotation error in degrees of (B, 3, 3) pairs:
    arccos((sum(rot1 * rot2) - 1) / 2), the cosine clipped to [-1, 1]."""
    cos_theta = (rot1 * rot2).sum(dim=(-2, -1))
    return torch.arccos(((cos_theta - 1.0) / 2.0).clamp(-1.0, 1.0)) \
        * (180.0 / math.pi)


def translation_error(t1: torch.Tensor, t2: torch.Tensor) -> torch.Tensor:
    """L2 translation error of (B, 3) pairs."""
    return torch.linalg.norm(t1 - t2, dim=1)


@torch.no_grad()
def dcp_metrics(src, tgt, rot_gt, trans_gt, rot_pred, trans_pred,
                r_th: float = 1.0, t_th: float = 0.1) -> Dict[str, torch.Tensor]:
    """Per-pair metric suite: src/tgt (B, N, 3) -> dict of (B,) tensors."""
    trans_pred = trans_pred.reshape(-1, 3)
    trans_gt = trans_gt.reshape(-1, 3)

    r_pred_euler = se3.mat2euler_zyx_deg(rot_pred)
    r_gt_euler = se3.mat2euler_zyx_deg(rot_gt)
    r_mse = ((r_gt_euler - r_pred_euler) ** 2).mean(dim=1)
    r_mae = (r_gt_euler - r_pred_euler).abs().mean(dim=1)
    t_mse = ((trans_gt - trans_pred) ** 2).mean(dim=1)
    t_mae = (trans_gt - trans_pred).abs().mean(dim=1)

    # isotropic residual of gt^-1 o pred
    gt_pose = torch.cat([rot_gt, trans_gt.unsqueeze(-1)], dim=-1)
    pred_pose = torch.cat([rot_pred, trans_pred.unsqueeze(-1)], dim=-1)
    residual = se3.concatenate(se3.inverse(gt_pose), pred_pose)
    rot_trace = residual[:, 0, 0] + residual[:, 1, 1] + residual[:, 2, 2]
    err_r_deg = torch.arccos((0.5 * (rot_trace - 1.0)).clamp(-1.0, 1.0)) \
        * (180.0 / math.pi)
    err_t = torch.linalg.norm(residual[:, :, 3], dim=-1)

    # Chamfer distances through the 1-NN dispatch point
    src_pred = se3.transform(pred_pose, src)
    src_gt = se3.transform(gt_pose, src)
    dist_src, dist_ref = nn1_both(src_pred, tgt)
    pcab = nn1(src_pred, src_gt)[0].mean(dim=1)
    chamfer = dist_src.mean(dim=1) + dist_ref.mean(dim=1)
    clip = 0.1
    clip_chamfer = (dist_src.sqrt().clamp_max(clip).mean(dim=1)
                    + dist_ref.sqrt().clamp_max(clip).mean(dim=1))
    n_correct = ((r_mae < r_th) & (t_mae < t_th)).float()
    return {
        "r_mse": r_mse, "r_mae": r_mae, "t_mse": t_mse, "t_mae": t_mae,
        "err_r_deg": err_r_deg, "err_t": err_t,
        "chamfer_dist": chamfer, "pcab_dist": pcab,
        "clip_chamfer_dist": clip_chamfer, "n_correct": n_correct,
    }


def summarize_metrics(metrics: Dict[str, np.ndarray]) -> Dict[str, float]:
    """Epoch reductions: *mse keys become *rmse (square root of the mean),
    err* keys get _mean and _rmse, the rest are means."""
    out = {}
    for k, v in metrics.items():
        v = np.asarray(v)
        if k.endswith("mse"):
            out[k[:-3] + "rmse"] = float(np.sqrt(np.mean(v)))
        elif k.startswith("err"):
            out[k + "_mean"] = float(np.mean(v))
            out[k + "_rmse"] = float(np.sqrt(np.mean(v ** 2)))
        else:
            out[k] = float(np.mean(v))
    return out


def print_metrics(summary: Dict[str, float], title: str = "Metrics",
                  log=None) -> None:
    """The metric report of an eval epoch, line by line through `log`
    (print by default)."""
    emit = log if log is not None else print
    emit("=" * (len(title) + 1))
    emit(title + ":")
    emit("DeepCP metrics: {:.4f}(rot-rmse) | {:.4f}(rot-mae) | "
         "{:.4g}(trans-rmse) | {:.4g}(trans-mae)".format(
             summary["r_rmse"], summary["r_mae"],
             summary["t_rmse"], summary["t_mae"]))
    emit("Rotation error {:.4f}(deg, mean) | {:.4f}(deg, rmse)".format(
        summary["err_r_deg_mean"], summary["err_r_deg_rmse"]))
    emit("Translation error {:.4g}(mean) | {:.4g}(rmse)".format(
        summary["err_t_mean"], summary["err_t_rmse"]))
    emit("Chamfer error: {:.7f}(mean-sq)".format(summary["chamfer_dist"]))
    emit("Source error: {:.7f}(mean-sq)".format(summary["pcab_dist"]))
    emit("Clip Chamfer error: {:.7f}(mean-sq)".format(
        summary["clip_chamfer_dist"]))
    emit("Recall: {:.7f}".format(summary["n_correct"]))
