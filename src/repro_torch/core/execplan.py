"""ExecPlan — one frozen value object for all sweep-execution config.

The counterpart of ``repro.core.execplan``:

  * :class:`ExecPlan` — backend, scenario chunking and the device.
    ``ExecPlan()`` is the fused CUDA kernel on ``"cuda"``.
  * the **backend registry** — :func:`register_backend` maps a name to an
    executor ``fn(compiled_bundle, host_view, plan) -> {field: matrix}``
    (:data:`~repro_torch.core.sweep_kernel.MATRIX_FIELDS` keys).  The
    builtins are ``"numpy"`` (the host), ``"torch"`` (unfused, on
    ``plan.device``) and ``"fused"`` (the CUDA bracket kernel on
    ``plan.device``).
  * :meth:`ExecPlan.parse` / :meth:`ExecPlan.to_string` — the CLI form
    ``"backend[:opt=val,...]"``, e.g. ``"torch:device=cpu,chunk=8"``.

A plan whose device is CUDA raises when no CUDA device is present: pricing
never moves to the CPU unless the plan names it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace
from typing import Callable

import torch

from .sweep_kernel import price_grid_fused, price_grid_numpy, price_grid_torch

_BACKENDS: dict[str, Callable] = {}


def register_backend(name: str, fn: Callable, *, overwrite: bool = False):
    """Register a sweep executor under ``name``:
    ``fn(cb, host_view, plan) -> {field: matrix}`` for every
    ``MATRIX_FIELDS`` key, each broadcastable to ``(n_scenarios,
    n_calls)``.  Registering an existing name raises unless
    ``overwrite=True``."""
    if not overwrite and name in _BACKENDS:
        raise ValueError(f"backend {name!r} is already registered "
                         "(pass overwrite=True to replace it)")
    _BACKENDS[name] = fn
    return fn


def known_backends() -> tuple:
    """Sorted names of every registered sweep backend."""
    return tuple(sorted(_BACKENDS))


def resolve_backend(name: str) -> Callable:
    """Look up a registered executor; unknown names raise the one
    canonical usage error."""
    try:
        return _BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r} (registered: "
            f"{', '.join(known_backends())})") from None


@dataclass(frozen=True)
class ExecPlan:
    """How to execute a scenario sweep — everything except the physics.

    Fields:
      * ``backend`` — a :func:`register_backend` name (builtins:
        ``"numpy"``, ``"torch"``, ``"fused"``).
      * ``chunk_scenarios`` — evaluate the grid in scenario-axis chunks of
        this size; peak intermediates drop to ``O(chunk x n_samples)``
        with bit-identical results.  ``None`` = one pass.
      * ``device`` — where ``"torch"`` and ``"fused"`` price (a
        ``torch.device`` string); ``"numpy"`` always prices on the host.
    """

    backend: str = "fused"
    chunk_scenarios: int | None = None
    device: str = "cuda"

    def __post_init__(self):
        if self.chunk_scenarios is not None and self.chunk_scenarios < 1:
            raise ValueError("chunk_scenarios must be >= 1, got "
                             f"{self.chunk_scenarios}")
        torch.device(self.device)          # raises on a malformed name

    def torch_device(self) -> torch.device:
        """:attr:`device` as a ``torch.device``; raises if it is CUDA and
        no CUDA device is present."""
        dev = torch.device(self.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"ExecPlan({self.backend!r}) prices on {self.device!r} but "
                "no CUDA device is present; name device='cpu' (or the "
                "'numpy' backend) to price on the host")
        return dev

    def replace(self, **kw) -> "ExecPlan":
        return replace(self, **kw)

    #: CLI option spellings accepted by :meth:`parse` -> (field, converter);
    #: the dict order is the canonical emission order of :meth:`to_string`.
    _PARSE_OPTS = {"chunk": ("chunk_scenarios", int),
                   "device": ("device", str)}

    @classmethod
    def parse(cls, spec: str) -> "ExecPlan":
        """Parse the CLI form ``"backend[:opt=val,...]"`` (opts: ``chunk``,
        ``device``).  The backend name is validated against the registry
        here."""
        spec = (spec or "").strip()
        name, sep, opts = spec.partition(":")
        resolve_backend(name)                  # canonical unknown-name error
        kw: dict = {"backend": name}
        seen: set = set()
        for item in ([s.strip() for s in opts.split(",")] if sep else []):
            if not item:
                raise ValueError(
                    f"empty option segment in {spec!r} (expected "
                    f"backend[:opt=val,...], e.g. {name}:chunk=8)")
            key, eq, val = item.partition("=")
            if key in seen:
                raise ValueError(f"duplicate option {key!r} in {spec!r} "
                                 "(each opt may appear at most once)")
            seen.add(key)
            if key not in cls._PARSE_OPTS:
                raise ValueError(
                    f"unknown ExecPlan option {key!r} in {spec!r} "
                    f"(opts: {', '.join(sorted(cls._PARSE_OPTS))})")
            if not eq or not val:
                raise ValueError(f"option {key!r} in {spec!r} needs a value")
            field, conv = cls._PARSE_OPTS[key]
            kw[field] = conv(val)
        return cls(**kw)

    def to_string(self) -> str:
        """The inverse of :meth:`parse`: ``ExecPlan.parse(p.to_string()) ==
        p``.  Only non-default fields are emitted, in ``_PARSE_OPTS``
        order."""
        defaults = {f.name: f.default for f in dataclasses.fields(type(self))}
        opts = [f"{key}={getattr(self, fname)}"
                for key, (fname, _) in self._PARSE_OPTS.items()
                if getattr(self, fname) != defaults[fname]]
        return self.backend + (":" + ",".join(opts) if opts else "")


# --------------------------------------------------------------------------
# Builtin executors: host view in, device pricing, device tensors out
# --------------------------------------------------------------------------

def _run_numpy(cb, view, plan: ExecPlan) -> dict:
    return price_grid_numpy(cb, view.to("cpu"))


def _run_torch(cb, view, plan: ExecPlan) -> dict:
    return price_grid_torch(cb, view.to(plan.torch_device()))


def _run_fused(cb, view, plan: ExecPlan) -> dict:
    return price_grid_fused(cb, view.to(plan.torch_device()))


register_backend("numpy", _run_numpy)
register_backend("torch", _run_torch)
register_backend("fused", _run_fused)
