"""repro_torch.kernels — the W4A8 GEMM (fused and split), paged decode
attention, token-wise FP8 activation quantization and flash attention:
plain PyTorch versions (``ref``), CUDA kernels for Hopper (``csrc/``, built
by ``build``, bound by ``w4a8_fused``, ``decode_attn``, ``act_quant``,
``w4a8_matmul`` and ``flash_attn``) and the dispatch by device (``ops``)."""
