from ogmm_tpu_torch.ops.common import (cdist, cos_distance, cos_similarity,
                                       gather_neighbors,
                                       graph_feature, index_points, knn,
                                       l2_normalize, nn1, nn1_both,
                                       posenc_alpha, square_distance)
from ogmm_tpu_torch.ops.cuda_dgcnn import dgcnn_eval, dgcnn_eval_reference
from ogmm_tpu_torch.ops.cuda_em import sinkhorn_em, sinkhorn_em_reference
from ogmm_tpu_torch.ops.fps import farthest_point_sample, fps_combined
from ogmm_tpu_torch.ops.gmm import (get_anchor_corrs, get_local_corrs,
                                    gmm_params, og_params, wkeans, wkeans_plus)
from ogmm_tpu_torch.ops.icp import (estimate_normals_knn, icp_point_to_plane,
                                    icp_point_to_point, refine_registration)
from ogmm_tpu_torch.ops.sinkhorn import (contrastsk, log_boltzmann_kernel,
                                         sinkhorn)

__all__ = [
    "cdist", "cos_distance", "cos_similarity", "gather_neighbors", "graph_feature", "index_points",
    "knn", "l2_normalize", "nn1", "nn1_both", "posenc_alpha",
    "square_distance", "dgcnn_eval", "dgcnn_eval_reference", "sinkhorn_em",
    "sinkhorn_em_reference", "farthest_point_sample", "fps_combined",
    "get_anchor_corrs", "get_local_corrs", "gmm_params", "og_params",
    "wkeans", "wkeans_plus", "estimate_normals_knn", "icp_point_to_plane",
    "icp_point_to_point", "refine_registration", "contrastsk",
    "log_boltzmann_kernel", "sinkhorn",
]
