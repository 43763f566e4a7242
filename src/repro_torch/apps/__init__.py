"""The paper's applications: access-stream specs for ``repro_torch.memsim``,
their validation, and the programs themselves over stacked ranks
(``stencil.torch_impl``, ``hpcg.torch_impl``)."""
