"""The JAX package's ``examples/`` walk-throughs on the port's API, one
module each; run one with ``python -m repro_torch.examples.<name>`` (on the
card, or ``--device cpu``)."""
