"""The public wrapper of the flash-attention kernel.

``flash_attention`` keeps the reference's contract (``repro.kernels
.flash_attention.ops``): the same signature, and block sizes that must
divide S and T, so the same calls fail.  The CUDA kernels pick their own
tiles, so ``block_q`` and ``block_k`` only shape those checks.  For CPU
tensors it runs the plain version in ``ref``.  For CUDA tensors ``route``
picks the kernel from (dtype, head width) before the launch — bf16 at D in
{64, 128, 256} to the tensor-core kernel ``"sm90"``, the rest to the f32
kernel ``"simt"`` — and the wrapper launches it or raises: it never falls
back, and a failed build or launch never changes the route.  The kernels
are forward-only, as in the JAX package: an input that requires grad
raises.

``flash_attention.launches`` counts every kernel launch and
``flash_attention.route_launches`` the launches of each route (plain
integers; callers may reset them).  The checked call is the custom op
``repro_torch::flash_attention``, so a captured step
(``core.graph.capture``) holds the kernel as one node, as a Pallas call is
one custom-call in HLO; a captured call launches and counts nothing.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from . import flash_attention as _cuda
from .ref import attention_ref

_TYPES = (torch.float32, torch.bfloat16)


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The route (``"sm90"`` or ``"simt"``) a CUDA call with this dtype and
    head width takes; raises for a pair that no kernel takes."""
    if dtype not in _TYPES:
        raise ValueError(f"flash_attention takes float32/bfloat16, got "
                         f"{dtype}")
    for name in ("sm90", "simt"):
        dtypes, dims = _cuda.TAKES[name]
        if dtype in dtypes and head_dim in dims:
            return name
    raise ValueError(f"the kernels take head widths "
                     f"{_cuda.TAKES['simt'][1]}, got {head_dim}")


def _check(q, k, v, block_q: int, block_k: int) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B, S, Hq, D) and k, v (B, T, Hkv, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, Hq, D = q.shape
    Bk, T, Hkv, Dk = k.shape
    if Bk != B or Dk != D or Hkv < 1 or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)}: "
                         "batch and head width must agree and Hq must be a "
                         "multiple of Hkv")
    if not (q.dtype == k.dtype == v.dtype and q.device == k.device
            == v.device):
        raise ValueError("q, k and v must share dtype and device")
    bq, bk = min(block_q, S), min(block_k, T)
    if bq < 1 or bk < 1 or S % bq or T % bk:
        raise ValueError(f"block sizes must divide the sequence lengths: "
                         f"S={S}, T={T}, block_q={bq}, block_k={bk}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention is forward-only: it has no "
                           "backward kernel; call it under torch.no_grad() or "
                           "torch.inference_mode()")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, block_q: int = 128,
                    block_k: int = 128, q_offset: int = 0) -> torch.Tensor:
    """q: (B, S, Hq, D); k/v: (B, T, Hkv, D) -> (B, S, Hq, D) in q's dtype.

    Query head h attends over kv head h // (Hq // Hkv); with ``causal``,
    query position s sees kv positions t <= s + ``q_offset`` (q is the
    block of a longer sequence that starts at key position ``q_offset``:
    a sequence-sharded rank's queries against the keys gathered up to its
    block's end).
    """
    _check(q, k, v, block_q, block_k)
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    dev = q.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    if dev.type == "cuda":
        route(q.dtype, q.shape[-1])
    return flash_attention_op(q, k, v, causal, int(q_offset))


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, q_offset: int = 0) -> torch.Tensor:
    """The checked call as one op: the plain version on the CPU, the
    kernel on the card.  A capture records it as one node (its fake
    version gives the shape only, and launches and counts nothing)."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, q_offset=q_offset)
    path = route(q.dtype, q.shape[-1])
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if k.shape[1] == 0:
        raise ValueError("flash_attention needs at least one kv position")
    with torch.cuda.device(q.device):
        _cuda.launch(q, k, v, out, causal, path, q_offset)
    flash_attention.launches += 1
    flash_attention.route_launches[path] += 1
    return out


@flash_attention_op.register_fake
def _(q, k, v, causal, q_offset=0):
    return q.new_empty(q.shape)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flops(q_shape, k_shape, v_shape, *args, out_shape=None,
           **kwargs) -> int:
    """QK^T and PV over every (query, key) pair, as ``FlopCounterMode``
    counts ``scaled_dot_product_attention`` (causality, and a ``q_offset``,
    not discounted)."""
    B, S, Hq, D = q_shape
    return 4 * B * Hq * S * k_shape[1] * D


flash_attention.launches = 0
flash_attention.route_launches = {"sm90": 0, "simt": 0}
