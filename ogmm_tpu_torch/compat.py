"""Weights trained with the original PyTorch code, imported into the port.

The original saves `state_dict()`; this module maps that state_dict onto
the JAX package's variable tree (`convert_gmmreg_state_dict`,
`convert_deepgmr_state_dict`, the port's copy of `ogmm_tpu/compat.py`) and
`load_torch_checkpoint` carries the tree on to the port's `state_dict` with
`weights.convert_variables`.

Layout translations:
  * 1x1 Conv1d/Conv2d (out, in, 1[, 1]) -> Dense kernel (in, out)
  * BatchNorm weight/bias/running_mean/running_var -> scale/bias + batch_stats
  * MultiHeadAttention: the original splits heads channel-strided
    (`view(B, d_head, H, N)`: channel c = d*H + h) while this package splits
    them contiguously (c = h*d_head + d). The q/k/v projections' output
    channels and the merge's input channels are permuted accordingly
    (`_head_perm`), which makes the two attention computations identical.
  * PositionEncoding's final fuse conv (`pos.conv.*`) is in the original's
    state_dict but never applied by its forward: skipped.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from ogmm_tpu_torch.weights import convert_variables


def numpy_state_dict(sd) -> Dict[str, np.ndarray]:
    """A torch state_dict as plain numpy arrays."""
    out = {}
    for k, v in sd.items():
        out[k] = v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
    return out


def _dense(sd, name):
    w = np.asarray(sd[f"{name}.weight"], np.float32)
    kernel = w.reshape(w.shape[0], w.shape[1]).T            # (in, out)
    entry = {"kernel": kernel}
    if f"{name}.bias" in sd:
        entry["bias"] = np.asarray(sd[f"{name}.bias"], np.float32)
    return entry


def _bn(sd, name):
    params = {"scale": np.asarray(sd[f"{name}.weight"], np.float32),
              "bias": np.asarray(sd[f"{name}.bias"], np.float32)}
    stats = {"mean": np.asarray(sd[f"{name}.running_mean"], np.float32),
             "var": np.asarray(sd[f"{name}.running_var"], np.float32)}
    return params, stats


def _head_perm(d_model: int, num_heads: int) -> np.ndarray:
    """perm such that ours_channel[c] corresponds to torch_channel[perm[c]]."""
    dh = d_model // num_heads
    h, d = np.divmod(np.arange(d_model), dh)   # ours: c = h*dh + d
    return d * num_heads + h                   # torch: c = d*H + h


def _mha(sd, prefix: str, d_model: int, num_heads: int):
    perm = _head_perm(d_model, num_heads)
    out = {}
    for i in range(3):                         # q, k, v projections
        e = _dense(sd, f"{prefix}.proj.{i}")
        out[f"Dense_{i}"] = {"kernel": e["kernel"][:, perm],
                             "bias": e["bias"][perm]}
    merge = _dense(sd, f"{prefix}.merge")
    out["Dense_3"] = {"kernel": merge["kernel"][perm, :],
                      "bias": merge["bias"]}
    return out


def _transformer(sd, prefix: str, d_model: int, num_heads: int):
    return {
        "MultiHeadAttention_0": _mha(sd, f"{prefix}.attn", d_model, num_heads),
        "PointMLP_0": {"Dense_0": _dense(sd, f"{prefix}.mlp.0"),
                       "Dense_1": _dense(sd, f"{prefix}.mlp.3")},
    }


def _conv_head(sd, prefix: str, deep: bool):
    params: Dict = {}
    stats: Dict = {}
    layers = [(0, "Dense_0", "BN_0"), (3, "Dense_1", "BN_1" if deep else None)]
    if deep:
        layers.append((6, "Dense_2", None))
    for idx, dname, bname in layers:
        params[dname] = _dense(sd, f"{prefix}.net.{idx}")
        if bname is not None:
            p, s = _bn(sd, f"{prefix}.net.{idx + 1}")
            params[bname] = {"BatchNorm_0": p}
            stats[bname] = {"BatchNorm_0": s}
    return params, stats


def convert_gmmreg_state_dict(sd: Mapping[str, np.ndarray],
                              num_heads: int = 4,
                              emb_dims: int = 512
                              ) -> Tuple[Dict, Dict]:
    """The original GMMReg state_dict -> (params, batch_stats), the JAX
    package's variable trees (numpy leaves)."""
    params: Dict = {}
    stats: Dict = {}

    # DGCNN (emd.*) — explicit-param layout (ogmm_tpu/nn/dgcnn.py)
    dg_p: Dict = {}
    dg_s: Dict = {}
    for i in range(1, 6):
        w = np.asarray(sd[f"emd.conv{i}.weight"], np.float32)
        dg_p[f"w{i}"] = w[:, :, 0, 0].T if w.ndim == 4 else w[:, :, 0].T
        bp, bs = _bn(sd, f"emd.bn{i}")
        dg_p[f"bn{i}_scale"] = bp["scale"]
        dg_p[f"bn{i}_bias"] = bp["bias"]
        dg_s[f"bn{i}_mean"] = bs["mean"]
        dg_s[f"bn{i}_var"] = bs["var"]
    params["DGCNN_0"] = dg_p
    stats["DGCNN_0"] = dg_s

    # PositionEncoding (pos.*): dist branch then angle branch; the fuse conv
    # (pos.conv.*) is unused by the original forward and skipped
    pe_p: Dict = {}
    pe_s: Dict = {}
    for dense, bn, tname in ((0, 0, "pos.conv_dis.0"), (1, 1, "pos.conv_dis.3"),
                             (2, 2, "pos.conv_ang1.0"), (3, 3, "pos.conv_ang2.0")):
        pe_p[f"Dense_{dense}"] = _dense(sd, tname)
        bn_t = tname.rsplit(".", 1)[0] + f".{int(tname.rsplit('.', 1)[1]) + 1}"
        bp, bs = _bn(sd, bn_t)
        pe_p[f"BN_{bn}"] = {"BatchNorm_0": bp}
        pe_s[f"BN_{bn}"] = {"BatchNorm_0": bs}
    params["PositionEncoding_0"] = pe_p
    stats["PositionEncoding_0"] = pe_s

    # transformers: sattn1 -> _0, cattn -> _1, sattn2 -> _2 (construction order)
    for i, name in enumerate(("sattn1", "cattn", "sattn2")):
        params[f"TransformerBlock_{i}"] = _transformer(sd, name, emb_dims,
                                                       num_heads)

    # CONV heads: conv1 -> ConvHead_0, conv2 -> _1, proj -> _2, overlap -> _3
    for idx, (name, deep) in enumerate((("conv1", True), ("conv2", True),
                                        ("proj", False), ("overlap", True))):
        p, s = _conv_head(sd, name, deep)
        params[f"ConvHead_{idx}"] = p
        if s:
            stats[f"ConvHead_{idx}"] = s

    return params, stats


def convert_deepgmr_state_dict(sd: Mapping[str, np.ndarray]
                               ) -> Tuple[Dict, Dict]:
    """The original DeepGMR state_dict (baseline/deepgmr.py:56-61:
    backbone DGCNN + `cluster` CONV head) -> (params, batch_stats)."""
    params: Dict = {}
    stats: Dict = {}
    dg_p: Dict = {}
    dg_s: Dict = {}
    for i in range(1, 6):
        w = np.asarray(sd[f"backbone.conv{i}.weight"], np.float32)
        dg_p[f"w{i}"] = w[:, :, 0, 0].T if w.ndim == 4 else w[:, :, 0].T
        bp, bs = _bn(sd, f"backbone.bn{i}")
        dg_p[f"bn{i}_scale"] = bp["scale"]
        dg_p[f"bn{i}_bias"] = bp["bias"]
        dg_s[f"bn{i}_mean"] = bs["mean"]
        dg_s[f"bn{i}_var"] = bs["var"]
    params["DGCNN_0"] = dg_p
    stats["DGCNN_0"] = dg_s
    p, s = _conv_head(sd, "cluster", deep=True)
    params["ConvHead_0"] = p
    stats["ConvHead_0"] = s
    return params, stats


def load_torch_checkpoint(path: str, num_heads: int = 4, emb_dims: int = 512,
                          model_name: str = "GMMReg") -> dict:
    """Read a `.pt` state_dict saved by the original code -> the
    `state_dict()` of the port's model `model_name` (GMMReg or DeepGMR). The
    file is foreign, so it is read with `weights_only=True`: a state_dict
    of tensors needs nothing more."""
    sd = numpy_state_dict(torch.load(path, map_location="cpu",
                                     weights_only=True))
    if model_name == "DeepGMR":
        params, stats = convert_deepgmr_state_dict(sd)
    else:
        params, stats = convert_gmmreg_state_dict(sd, num_heads, emb_dims)
    return convert_variables({"params": params, "batch_stats": stats},
                             model_name)
