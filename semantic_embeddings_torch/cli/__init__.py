"""Command-line entry points (run with ``python -m semantic_embeddings_torch.cli.<name>``)."""
