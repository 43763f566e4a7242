"""ExecPlan — one frozen value object for all sweep-execution config.

The counterpart of ``repro.core.execplan``:

  * :class:`ExecPlan` — backend, scenario chunking, the device, the
    precision and the streaming options.  ``ExecPlan()`` is the fused CUDA
    kernel on ``"cuda"`` in float64.
  * the **backend registry** — :func:`register_backend` maps a name to an
    executor.  A matrix executor is ``fn(compiled_bundle, host_view, plan)
    -> {field: matrix}`` (:data:`~repro_torch.core.sweep_kernel.
    MATRIX_FIELDS` keys); a streaming one (``streaming=True``) owns its
    whole execution.  The builtins are ``"numpy"`` (the host), ``"torch"``
    (unfused, on ``plan.device``), ``"fused"`` (the CUDA bracket kernel on
    ``plan.device``) and the streaming ``"distributed"`` (the fused
    kernel chunk by chunk, reduced to a top-k on ``plan.device``).
  * :meth:`ExecPlan.parse` / :meth:`ExecPlan.to_string` — the CLI form
    ``"backend[:opt=val,...]"``, e.g. ``"torch:device=cpu,chunk=8"`` or
    ``"distributed:devices=4,topk=64,refine=2"``.

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
_STREAMING: set = set()


def register_backend(name: str, fn: Callable, *, streaming: bool = False,
                     overwrite: bool = False):
    """Register a sweep executor under ``name``.

    A MATRIX backend (the default) is ``fn(cb, host_view, plan) ->
    {field: matrix}`` for every ``MATRIX_FIELDS`` key, each broadcastable
    to ``(n_scenarios, n_calls)``; the execution core adds scenario-axis
    chunking and builds the ``SweepResult``.  A STREAMING backend
    (``streaming=True``) is ``fn(cb, scenarios, plan, mpi_transfer,
    free_transfer)``: it takes the scenario set itself and returns a
    reduced result (a ``TopKSweepResult``) without ever holding the full
    ``(S, n_calls)`` matrices.  Registering an existing name raises unless
    ``overwrite=True``."""
    if not overwrite and name in _BACKENDS:
        raise ValueError(f"backend {name!r} is already registered "
                         "(pass overwrite=True to replace it)")
    _BACKENDS[name] = fn
    _STREAMING.discard(name)
    if streaming:
        _STREAMING.add(name)
    return fn


def known_backends() -> tuple:
    """Sorted names of every registered sweep backend."""
    return tuple(sorted(_BACKENDS))


def is_streaming(name: str) -> bool:
    """Whether ``name`` was registered as a streaming backend."""
    return name in _STREAMING


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
      * ``device`` — where ``"torch"``, ``"fused"`` and ``"distributed"``
        price (a ``torch.device`` string); ``"numpy"`` always prices on
        the host.
      * ``x64`` — price in float64 (the default, parity-pinned); ``False``
        prices in float32 (the view, the bundle's constants and the
        kernel's float instantiation).  ``"numpy"`` stays float64.
      * ``devices`` — (distributed) split each streamed chunk into this
        many shards, stacked along a leading axis on ``device``
        (``None`` = 1).
      * ``topk`` — (streaming) how many best-by-speedup scenarios survive
        the reduction, with full rows kept for exactly these.
      * ``refine`` — (distributed, a refinable scenario set) adaptive
        frontier-refinement rounds after the seed set; each re-samples
        ``len(seed)`` scenarios around the current speedup frontier.
    """

    backend: str = "fused"
    chunk_scenarios: int | None = None
    device: str = "cuda"
    x64: bool = True
    devices: int | None = None
    topk: int = 64
    refine: int = 0

    def __post_init__(self):
        if self.chunk_scenarios is not None and self.chunk_scenarios < 1:
            raise ValueError("chunk_scenarios must be >= 1, got "
                             f"{self.chunk_scenarios}")
        torch.device(self.device)          # raises on a malformed name
        if self.devices is not None and self.devices < 1:
            raise ValueError(f"devices must be >= 1, got {self.devices}")
        if self.topk < 1:
            raise ValueError(f"topk must be >= 1, got {self.topk}")
        if self.refine < 0:
            raise ValueError(f"refine must be >= 0, got {self.refine}")

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

    @property
    def dtype(self) -> torch.dtype:
        """The pricing dtype of the torch backends."""
        return torch.float64 if self.x64 else torch.float32

    def executor(self) -> Callable:
        """The registered executor for :attr:`backend`."""
        return resolve_backend(self.backend)

    def replace(self, **kw) -> "ExecPlan":
        return replace(self, **kw)

    #: CLI option spellings accepted by :meth:`parse` -> (field, converter);
    #: the dict order is the canonical emission order of :meth:`to_string`.
    _PARSE_OPTS = {"chunk": ("chunk_scenarios", int),
                   "device": ("device", str),
                   "x64": ("x64", bool),
                   "devices": ("devices", int),
                   "topk": ("topk", int),
                   "refine": ("refine", int)}
    _BOOLS = {"1": True, "true": True, "yes": True,
              "0": False, "false": False, "no": False}

    @classmethod
    def parse(cls, spec: str) -> "ExecPlan":
        """Parse the CLI form ``"backend[:opt=val,...]"`` (opts: ``chunk``,
        ``device``, ``x64`` (``0/1/true/false``), ``devices``, ``topk``,
        ``refine``).  The backend name is validated against the registry
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
            if conv is bool:
                if val.lower() not in cls._BOOLS:
                    raise ValueError(f"option {key!r} in {spec!r} takes "
                                     f"0/1/true/false, got {val!r}")
                kw[field] = cls._BOOLS[val.lower()]
            else:
                kw[field] = conv(val)
        return cls(**kw)

    def to_string(self) -> str:
        """The inverse of :meth:`parse`: ``ExecPlan.parse(p.to_string()) ==
        p``.  Only non-default fields are emitted, in ``_PARSE_OPTS``
        order."""
        defaults = {f.name: f.default for f in dataclasses.fields(type(self))}
        opts = [f"{key}={int(val) if conv is bool else val}"
                for key, (fname, conv) in self._PARSE_OPTS.items()
                if (val := getattr(self, fname)) != defaults[fname]]
        return self.backend + (":" + ",".join(opts) if opts else "")


# --------------------------------------------------------------------------
# Builtin executors: host view in, device pricing, device tensors out
# --------------------------------------------------------------------------

def _run_numpy(cb, view, plan: ExecPlan) -> dict:
    return price_grid_numpy(cb, view.to("cpu"))


def _run_torch(cb, view, plan: ExecPlan) -> dict:
    return price_grid_torch(cb, view.to(plan.torch_device(), plan.dtype))


def _run_fused(cb, view, plan: ExecPlan) -> dict:
    return price_grid_fused(cb, view.to(plan.torch_device(), plan.dtype))


def _run_distributed(cb, scenarios, plan: ExecPlan, mpi_transfer=None,
                     free_transfer=None):
    # lazy import: adaptive builds on sweep, which imports this module
    from .adaptive import run_distributed
    return run_distributed(cb, scenarios, plan, mpi_transfer=mpi_transfer,
                           free_transfer=free_transfer)


register_backend("numpy", _run_numpy)
register_backend("torch", _run_torch)
register_backend("fused", _run_fused)
register_backend("distributed", _run_distributed, streaming=True)
