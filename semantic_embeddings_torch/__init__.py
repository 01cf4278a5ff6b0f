"""semantic_embeddings_torch — the PyTorch and CUDA port of semantic_embeddings_tpu.

Runs on an NVIDIA Hopper GPU (H100).  The layout mirrors the JAX package,
module for module and function for function; that package stays the
reference the port is tested against.  This package imports ``torch`` and
never ``jax``.

- ``ops``     — hand-written CUDA kernels (``csrc/``) with their plain
                PyTorch versions: the fused L2-norm + dot cosine loss, the
                3x3 conv + BN statistics and its filter gradient, each a
                ``torch.library`` custom op (``semantic_embeddings_torch::``).
- ``models``  — the model zoo, the embedding/classification heads and the
                baseline learners' models.
- ``train``   — losses, metrics, Keras-exact SGD and Adagrad, schedules, the
                train steps of every learner.
- ``data``    — device-resident in-memory datasets and on-device augmentation.
- ``hierarchy``, ``embeddings``, ``evaluation`` — taxonomy math, the
                class-embedding solvers, their pickle I/O and hierarchical
                precision: host numpy, the port's own copies of the JAX
                package's numpy-only modules.
- ``cli``     — command-line entry points (``python -m
                semantic_embeddings_torch.cli.learn_image_embeddings`` and
                the JAX package's other CLIs: evaluation, the baseline
                learners, ``export_model``, ``serve_model``).
- ``parallel`` — data parallelism: process groups (``--gpus``), batch
                slices, the collectives of the gradient and of sync BN,
                device lists for retrieval and serving.
- ``serving`` — the batching engine, HTTP server and client.
- ``convert`` — Flax variable tree <-> ``state_dict`` bridge.

The port imports nothing of the JAX package, not even its numpy-only
modules: it keeps its own copies of them.
"""

__version__ = "0.1.0"
