"""repro_torch.launch — step builders (the training step so far)."""
