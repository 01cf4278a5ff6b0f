"""semantic_embeddings_torch — the PyTorch and CUDA port of semantic_embeddings_tpu.

Runs on an NVIDIA Hopper GPU (H100).  The layout mirrors the JAX package,
module for module and function for function; that package stays the
reference the port is tested against.  This package imports ``torch`` and
never ``jax``.

- ``ops``     — hand-written CUDA kernels (``csrc/``) with their plain
                PyTorch versions: the fused L2-norm + dot cosine loss.
- ``models``  — CIFAR ResNets and the embedding/classification heads.
- ``train``   — losses, metrics, Keras-exact SGD, schedules, the train step.
- ``data``    — device-resident in-memory datasets and on-device augmentation.
- ``cli``     — command-line entry points (``python -m
                semantic_embeddings_torch.cli.learn_image_embeddings``).
- ``convert`` — Flax variable tree <-> ``state_dict`` bridge.

Taxonomy math, the class-embedding solvers and their pickle I/O are
imported from the JAX package's numpy-only modules
(``semantic_embeddings_tpu.hierarchy``, ``.embeddings``).
"""

__version__ = "0.1.0"
