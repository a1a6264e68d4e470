"""repro_torch.kernels — the W4A8 GEMM and paged decode attention: plain
PyTorch versions (``ref``), CUDA kernels for Hopper (``csrc/``, built by
``build``, bound by ``w4a8_fused`` and ``decode_attn``) and the dispatch
by device (``ops``)."""
