#!/usr/bin/env python3
"""One train step's loss and gradients with the DGCNN backward kernels on
(`ops.dgcnn_train.BWD_KERNELS`), compared between two trees of the port.

    python3 scripts/bwd_step_ab.py TREE_A TREE_B

Each tree's `ogmm_tpu_torch` runs in a process of its own, on the same
seeded state and batch: ModelNet shape (B=24, N=717, emb 512, K=128, bf16
body, overlap labels made in the step), anchors from index 0. Prints each
tree's loss (repr), whether the losses are bit-equal, and the gradients'
relative difference sqrt(sum |g_a - g_b|^2 / sum |g_b|^2) over all
parameters. Needs one CUDA device; JAX is not used.
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

B, N = 24, 717


def batch(seed=0):
    """Clouds and rotated, shifted copies with a third of each target
    replaced by points off the source (partial overlap)."""
    rs = np.random.RandomState(seed)
    src = (rs.randn(B, N, 3) * 0.3).astype(np.float32)
    q, _ = np.linalg.qr(rs.randn(B, 3, 3))
    rot = (q * np.sign(np.linalg.det(q))[:, None, None]).astype(np.float32)
    trans = rs.uniform(-0.5, 0.5, (B, 3)).astype(np.float32)
    tgt = src @ rot.transpose(0, 2, 1) + trans[:, None]
    tgt[:, :N // 3] = (rs.randn(B, N // 3, 3) * 0.3 + 1.0).astype(np.float32)
    ones = np.ones((B, N), np.float32)
    return {"src_xyz": src, "tgt_xyz": tgt.astype(np.float32), "src_overlap": ones,
            "tgt_overlap": ones,
            "transform_gt": np.concatenate([rot, trans[:, :, None]], -1)}


def child(tree, out):
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from ogmm_tpu_torch import configs
    from ogmm_tpu_torch.ops import dgcnn_train
    from ogmm_tpu_torch.train import create_train_state, train_loss
    cfg = configs.mnet(model=configs.ModelConfig(dtype="bfloat16"))
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, device_overlap=True),
                      data=dataclasses.replace(cfg.data, fix_tgt_overlap=True))
    state = create_train_state(cfg, steps_per_epoch=100, seed=0, device="cuda")
    state.generator = None
    dgcnn_train.BWD_KERNELS = True
    loss, _ = train_loss(state, cfg, batch())
    loss.backward()
    torch.save({"loss": loss.item(),
                "grads": {n: p.grad.detach().cpu()
                          for n, p in state.model.named_parameters()}}, out)


def main():
    if sys.argv[1] == "--child":
        child(sys.argv[2], sys.argv[3])
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, tree in enumerate(sys.argv[1:3]):
            out = os.path.join(tmp, f"{i}.pt")
            subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree,
                            out], check=True)
            runs.append(torch.load(out))
    a, b = runs
    num = sum(((a["grads"][n] - g) ** 2).sum() for n, g in b["grads"].items())
    den = sum((g ** 2).sum() for g in b["grads"].values())
    result = {"trees": sys.argv[1:3], "losses": [repr(a["loss"]), repr(b["loss"])],
              "loss_bit_equal": a["loss"] == b["loss"],
              "grad_rel": float((num / den).sqrt())}
    print(json.dumps(result))


if __name__ == "__main__":
    main()
