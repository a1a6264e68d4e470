"""repro_torch.runtime — the paged KV pool, sampling (JAX's threefry), the
serving engine and its asyncio/SSE front-end."""
