"""repro_torch.models — the dense decoder family: config, parameter trees,
layers, paged GQA attention, the transformer and its serving step, and the
weight bridge from the JAX package."""
