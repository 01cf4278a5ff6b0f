"""Hand-written CUDA kernels for the hot paths, with their plain versions;
and the plain-PyTorch exact top-k of the retrieval path."""

from .cosine_loss import fused_cosine_loss, l2_normalize
from .topk import exact_topk, exact_topk_payload

__all__ = ["fused_cosine_loss", "l2_normalize", "exact_topk", "exact_topk_payload"]
