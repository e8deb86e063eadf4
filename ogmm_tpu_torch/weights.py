"""Weights of the JAX package carried over to this package's `state_dict`.

The JAX package keeps a nested `{'params': ..., 'batch_stats': ...}` tree
and exports it as a flat `.npz` (keys `params/...`, `batch_stats/...`, and
the config as JSON under `__config__`). `convert_variables` maps either form
to the names and layouts of `ogmm_tpu_torch.nn.GMMReg` or `.DeepGMR`, by
the model's name (`MODULES`): Dense kernels (in, out) become Linear weights
(out, in); BatchNorm scale/bias/mean/var become
weight/bias/running_mean/running_var; the DGCNN's own parameters keep their
names and their (in, out) layout. `flat_variables` is the inverse: a
`state_dict` back to the flat keys of the JAX package.
"""
from __future__ import annotations

import json
import re
from collections.abc import Mapping

import numpy as np
import torch

from ogmm_tpu_torch.configs import Config, config_from_dict

# the JAX package's top-level modules of each model -> the port's attributes
MODULES = {
    "GMMReg": {
        "DGCNN_0": "dgcnn", "PositionEncoding_0": "pos_enc",
        "TransformerBlock_0": "sattn1", "TransformerBlock_1": "cattn",
        "TransformerBlock_2": "sattn2", "ConvHead_0": "conv1",
        "ConvHead_1": "conv2", "ConvHead_2": "proj", "ConvHead_3": "overlap",
    },
    "DeepGMR": {"DGCNN_0": "backbone", "ConvHead_0": "cluster"},
}
_INNER = {"MultiHeadAttention_0": "mha", "PointMLP_0": "mlp"}
_BN_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}


def flatten_variables(tree: Mapping, prefix: str = "") -> dict:
    """Nested tree -> {'params/A/B/kernel': array} (an already flat mapping
    passes through)."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_variables(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _convert_key(parts: list[str], top: dict):
    """Path below the collection -> (state_dict key, transpose?), with
    `top` the model's map of `MODULES`."""
    if parts[0] not in top:
        raise KeyError(f"unknown module {parts[0]!r}")
    names = [top[parts[0]]]
    if parts[0] == "DGCNN_0":
        return f"{names[0]}.{parts[1]}", False
    leaf = parts[-1]
    is_bn = False
    for p in parts[1:-1]:
        if p in _INNER:
            names.append(_INNER[p])
        elif m := re.fullmatch(r"Dense_(\d+)", p):
            names.append(f"dense{m.group(1)}")
        elif m := re.fullmatch(r"BN_(\d+)", p):
            names.append(f"bn{m.group(1)}")
            is_bn = True
        elif p != "BatchNorm_0":
            raise KeyError(f"unknown module {p!r} in {'/'.join(parts)}")
    if is_bn:
        return ".".join(names + [_BN_LEAF[leaf]]), False
    if leaf == "kernel":
        return ".".join(names + ["weight"]), True
    return ".".join(names + [leaf]), False


def convert_variables(variables: Mapping,
                      model_name: str = "GMMReg") -> dict[str, torch.Tensor]:
    """JAX-package variables (nested or flat) of model `model_name` -> the
    `state_dict()` of the port's model."""
    top = MODULES[model_name]
    state = {}
    for key, value in flatten_variables(variables).items():
        coll, *parts = key.split("/")
        if coll not in ("params", "batch_stats"):
            continue
        name, transpose = _convert_key(parts, top)
        arr = np.asarray(value, dtype=np.float32)
        state[name] = torch.from_numpy(np.ascontiguousarray(
            arr.T if transpose else arr).copy())
    return state


_INNER_INV = {v: k for k, v in _INNER.items()}
_BN_LEAF_INV = {v: k for k, v in _BN_LEAF.items()}


def _flat_key(name: str, top_inv: dict) -> tuple[str, bool]:
    """`state_dict` key -> (flat JAX key, transpose?): the inverse of
    `_convert_key`, with `top_inv` the model's map of `MODULES` inverted."""
    top, *rest = name.split(".")
    if top_inv[top] == "DGCNN_0":
        coll = ("batch_stats" if rest[0].endswith(("_mean", "_var"))
                else "params")
        return f"{coll}/DGCNN_0/{rest[0]}", False
    parts, is_bn = [top_inv[top]], False
    for p in rest[:-1]:
        if p in _INNER_INV:
            parts.append(_INNER_INV[p])
        elif m := re.fullmatch(r"dense(\d+)", p):
            parts.append(f"Dense_{m.group(1)}")
        elif m := re.fullmatch(r"bn(\d+)", p):
            parts += [f"BN_{m.group(1)}", "BatchNorm_0"]
            is_bn = True
        else:
            raise KeyError(f"unknown module {p!r} in {name}")
    leaf = rest[-1]
    if is_bn:
        leaf = _BN_LEAF_INV[leaf]
        coll = "batch_stats" if leaf in ("mean", "var") else "params"
        return "/".join([coll, *parts, leaf]), False
    if leaf == "weight":
        return "/".join(["params", *parts, "kernel"]), True
    return "/".join(["params", *parts, leaf]), False


def flat_variables(state: Mapping[str, torch.Tensor],
                   model_name: str = "GMMReg") -> dict[str, np.ndarray]:
    """The `state_dict()` of the port's model `model_name` -> {'params/...':
    array, 'batch_stats/...': array}, the flat form of the JAX package's
    variables."""
    top_inv = {v: k for k, v in MODULES[model_name].items()}
    out = {}
    for name, value in state.items():
        key, transpose = _flat_key(name, top_inv)
        arr = value.detach().cpu().float().numpy()
        out[key] = np.ascontiguousarray(arr.T if transpose else arr)
    return out


def load_weights(path: str, model_name: str | None = None
                 ) -> tuple[dict[str, torch.Tensor], Config | None]:
    """Read an exported `.npz` -> (state_dict, Config or None). The weights
    are those of `model_name`, by default the model the embedded config
    names (GMMReg without one)."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    raw = flat.pop("__config__", None)
    cfg = None
    if raw is not None:
        cfg = config_from_dict(json.loads(raw.tobytes().decode()))
    if model_name is None:
        model_name = cfg.model_name if cfg is not None else "GMMReg"
    return convert_variables(flat, model_name), cfg
