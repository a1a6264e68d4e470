"""repro_torch.runtime — the paged KV pool, greedy sampling and the
serving engine."""
