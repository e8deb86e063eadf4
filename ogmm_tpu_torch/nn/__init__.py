from ogmm_tpu_torch.nn.attention import (MultiHeadAttention, PositionEncoding,
                                         TransformerBlock)
from ogmm_tpu_torch.nn.deepgmr import DeepGMR, gmm_register
from ogmm_tpu_torch.nn.dgcnn import DGCNN
from ogmm_tpu_torch.nn.gmmreg import GMMReg, gmm_svd
from ogmm_tpu_torch.nn.layers import ConvHead, PointMLP

__all__ = ["ConvHead", "PointMLP", "DGCNN", "MultiHeadAttention",
           "PositionEncoding", "TransformerBlock", "GMMReg", "gmm_svd",
           "DeepGMR", "gmm_register"]
