"""ogmm_tpu_torch: OGMM point-cloud registration (GMMs weighted by overlap) in PyTorch
with hand-written CUDA kernels for NVIDIA Hopper.

The port of the JAX package `ogmm_tpu`, one slice at a time: its two models,
GMMReg (DGCNN edge-conv features, anchor-conditioned transformer overlap
prediction, overlap-weighted Sinkhorn-EM clustering, a weighted-Procrustes
closed-form solve) and DeepGMR (a softmax clustering head and the
closed-form alignment of two GMMs), each with the batched ICP refinement,
served, trained and fed by the ModelNet and indoor data pipelines. It
imports `torch` only; entry points run on the CUDA device unless the caller
asks for the CPU.
"""

__version__ = "0.1.0"
