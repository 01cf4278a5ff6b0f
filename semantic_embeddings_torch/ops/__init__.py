"""Hand-written CUDA kernels for the hot paths, with their plain versions;
and the plain-PyTorch exact top-k of the retrieval path.

Importing this package registers the kernels' ``torch.library`` custom ops
(``semantic_embeddings_torch::cosine_loss_fwd``, ``::cosine_loss_bwd``,
``::conv3x3_bn_stats``, ``::conv3x3_filter_grad``, ``::conv1x1_filter_grad``),
which a loaded ``export_model`` artifact may call."""

from . import conv1x1  # noqa: F401  (registers its op)
from .conv3x3 import conv3x3_bn_stats
from .cosine_loss import fused_cosine_loss, l2_normalize
from .topk import exact_topk, exact_topk_payload

__all__ = ["conv3x3_bn_stats", "fused_cosine_loss", "l2_normalize", "exact_topk",
           "exact_topk_payload"]
