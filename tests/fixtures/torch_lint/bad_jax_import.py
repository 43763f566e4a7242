"""Lint fixture: the port reaching for jax and the JAX package."""
import importlib

import torch


def lazily():
    import jax.numpy as jnp          # inside a function counts too
    from repro.core import price
    return jnp, price, importlib.import_module("jaxlib")


def fine():
    from repro_torch.core import price    # the port itself is fine
    return torch.zeros(1), price
