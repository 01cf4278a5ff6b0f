"""Online serving runtime: dynamic micro-batching and an HTTP frontend
(counterpart of the JAX package's ``serving``).  Serves a checkpoint behind
a bucketed dynamic batcher, so that concurrent requests share device calls;
see ``cli/serve_model.py`` for the CLI."""

from .client import ServingClient, ServingError
from .engine import BatchingEngine, EngineOverloaded, Future, default_buckets
from .server import Preprocessor, PreprocessError, ServingServer, make_handler

__all__ = [
    "BatchingEngine",
    "EngineOverloaded",
    "ServingClient",
    "ServingError",
    "Future",
    "default_buckets",
    "Preprocessor",
    "PreprocessError",
    "ServingServer",
    "make_handler",
]
