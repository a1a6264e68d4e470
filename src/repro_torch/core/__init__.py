"""repro_torch.core — FP-format post-training quantization: grids, scales,
quantizers, LoRC, the policy object and the RTN packing (``ptq``)."""
