"""repro_torch.models — the decoder families ported so far (dense GQA, MLA,
MoE): config, parameter trees, layers, paged GQA and MLA attention, the
MoE layer, the transformer and its serving step, and the weight bridge
from the JAX package."""
