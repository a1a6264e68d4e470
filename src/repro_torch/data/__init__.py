"""repro_torch.data — the seeded synthetic token streams (training,
calibration and evaluation batches)."""
