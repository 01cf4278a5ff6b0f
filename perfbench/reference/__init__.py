"""Plain PyTorch references of the benchmark's configurations, one module an
architecture, and the training step they share (:mod:`.plain`)."""
