"""repro_torch — the PyTorch/CUDA port of the CXL.mem message-free
communication model, beside the JAX package ``repro`` (the reference).

It imports ``torch`` and ``numpy``, never ``jax`` and never ``repro``.
Slice 1 holds the pricing path: ``memsim`` and the stencil spec produce a
``TraceBundle``; ``core.compile_bundle`` packs it; ``core.price`` prices it
under a ``ParamGrid`` on the GPU, with the fused bracket kernel of
``kernels.sweep_bracket`` (CUDA C++ for sm_90a).
"""
