"""repro_torch.checkpoint — step-atomic checkpoints in the reference's format."""
