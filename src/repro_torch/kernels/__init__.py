"""Hand-written CUDA kernels of the PyTorch port (Hopper, sm_90a).

Each kernel package mirrors ``repro.kernels``: the launcher module builds
and binds the CUDA source under ``csrc/``, ``ops.py`` is the wrapper with
the reference's shape contract, and ``ref.py`` is the plain PyTorch
version that CPU tensors run.

  sweep_bracket/  fused bracket-term + per-site segment sum for the
                  scenario sweep (the ``"fused"`` backend), and a generic
                  CSR segment sum
  halo_exchange/  the message-free ring halo exchange (HPCG's
                  ``"message_free"`` backend on the card): each rank's
                  CTAs write its boundary planes into the neighbours'
                  windows under a release/acquire flag handshake
  flash_attention/
                  blockwise online-softmax attention (GQA, causal), the
                  LM's attention with ``use_kernel``
  mamba_scan/     the Mamba-1 selective scan, the LM's SSM mixer with
                  ``use_kernel``
  stencil27/      HPCG's 27-point operator: one pass over each z-slab
                  rank and its two ghost planes (``apply_a`` on the card)

``_build`` compiles each ``csrc/*.cu`` with ``nvcc`` and loads it with
``ctypes``.
"""
