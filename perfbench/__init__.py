"""The benchmark of the PyTorch and CUDA port (``repro_torch``): see
``README.md`` here and ``BENCHMARK.json`` at the root of the checkout."""
