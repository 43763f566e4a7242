"""repro_torch — the PyTorch/CUDA port of the CXL.mem message-free
communication model, beside the JAX package ``repro`` (the reference).

It imports ``torch`` and ``numpy``, never ``jax`` and never ``repro``.

* The pricing path: ``memsim`` and the app specs produce a ``TraceBundle``;
  ``core.compile_bundle`` packs it; ``core.price`` prices it under a
  ``ParamGrid`` on the GPU, with the fused bracket kernel of
  ``kernels.sweep_bracket`` (CUDA C++ for sm_90a).
* The paper's apps: ``apps.stencil.torch_impl`` and ``apps.hpcg.torch_impl``
  run over a grid of ranks stacked on one device (``comm.grid_mesh``), with
  message-based or message-free halo exchange (``comm``); HPCG's
  message-free exchange on the card is the CUDA kernel of
  ``kernels.halo_exchange``.  ``apps.*.validation`` reproduce the paper's
  model-vs-reference rows.
* The LM stack's forward pass: ``models`` (``make_model``, ``make_inputs``,
  ``LanguageModel.forward`` / ``loss``) over the arch registry
  ``configs``; with ``use_kernel`` attention and the Mamba scan run the
  CUDA kernels of ``kernels.flash_attention`` and ``kernels.mamba_scan``.
* Serving (``serve``), the advisor on compiled programs (``core.graph``,
  ``core.advisor``) and training (``train``, ``launch.train``).
* Parallelism over ``torch.distributed`` ranks: ``launch.mesh`` (process
  groups, device meshes), ``parallel`` (the sharding rules, the GPipe
  pipeline, the compressed all-reduce), EP-local MoE (``moe_impl=
  "ep_local"`` with a mesh), data parallelism with ZeRO-1 in the train
  step, elastic checkpoint restore, and the ``"distributed"`` sweep over
  ranks.
"""
