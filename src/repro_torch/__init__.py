"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package keeps its module
layout and names so each counterpart is easy to find, and never imports
``jax`` or anything under ``repro``. Entry points (``models.init_params``,
``core.ptq.pack_params``, ``runtime.serve.Server``) run on ``cuda`` unless
the caller passes ``device="cpu"``; without a GPU and without that explicit
request they raise instead of falling back to the CPU.
"""
