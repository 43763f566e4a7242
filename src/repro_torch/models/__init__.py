"""The LM stack of the port: the forward pass of every assigned
architecture (dense, MoE, hybrid, SSM, VLM and audio backbones).

``factory.make_model`` / ``factory.make_inputs`` are the entry points;
``LanguageModel.forward`` returns (logits, aux) and ``loss`` the mean
next-token cross-entropy.  With ``use_kernel`` the attention layers run the
CUDA kernel of ``kernels.flash_attention`` and the Mamba layers the one of
``kernels.mamba_scan``.  ``convert.params_from_jax`` loads the JAX
package's parameters, so that both compute the same function.
``prefill`` / ``decode_step`` / ``init_caches`` serve it (``repro_torch
.serve``); ``convert.caches_from_jax`` loads the reference's caches.
"""
from .config import ArchConfig, ShapeConfig, SHAPES
from .factory import (abstract_caches, abstract_params, decode_inputs,
                      make_inputs, make_model)
from .lm import LanguageModel

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "LanguageModel",
           "abstract_params", "abstract_caches", "decode_inputs",
           "make_inputs", "make_model"]
