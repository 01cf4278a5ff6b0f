"""Hand-written CUDA kernels for the hot paths, with their plain versions."""

from .cosine_loss import fused_cosine_loss, l2_normalize

__all__ = ["fused_cosine_loss", "l2_normalize"]
