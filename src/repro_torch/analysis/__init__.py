"""Static analysis of the port, in four tiers: source (AST), kernel launch
geometry, kernel dataflow, and captured steps.  The counterpart of the JAX
package's ``analysis`` tier; each module keeps its reference's name.

AST tier, stdlib only:

  * ``python -m repro_torch.lint [paths]``: the pluggable AST linter
    (:mod:`repro_torch.analysis.lint`).  Rules live in an open registry
    (:func:`register_rule`) and hold the port's own rules: no ``jax`` or
    ``repro`` import at any depth (``jax-import``), no fallback from a
    kernel to its plain version (``kernel-fallback``), kernels built only
    at first use (``import-time-build``), no host sync in a hot path
    (``host-sync-in-hot-path``), no capture or compile in a loop
    (``compile-in-loop``), no process-wide dtype or TF32 switch left set
    (``default-dtype-leak``), and pragma hygiene (``unknown-noqa``).

Launch geometry: ``python -m repro_torch.analysis.kernelcheck`` holds each
kernel package's launch plan (``ops.plan``, the mirror of the plan
function its CUDA launcher calls) for representative shapes against the
wrappers' shape contract and what an H100 refuses: threads, shared
memory, grid y and z, cluster size, a cooperative grid's co-residency and
the TMA maps' strides and boxes (:mod:`repro_torch.analysis.kernelcheck`).

Kernel dataflow: ``python -m repro_torch.analysis.dataflow`` enumerates
each launch's CTAs and the output region each writes (the ``DATAFLOW``
contract next to each kernel's ``ops.plan``): every element written
(``tile-uncovered``), by one CTA (``write-race``), inside its array
(``block-oob``), every grid axis moving a region (``dropped-grid-index``),
and each plan's shared memory by buffer (:mod:`repro_torch.analysis
.dataflow`).

Captured steps: ``python -m repro_torch.analysis.ircheck`` captures the
registered entry points with ``core.graph.capture`` and checks the
capture: peak live bytes and copy bytes against committed budgets, float64
promotion, host syncs, in-place updates that do not happen, and
collectives against the mesh (:mod:`repro_torch.analysis.ircheck`).

This ``__init__`` stays stdlib-only (the linter runs without torch);
``kernelcheck``, ``dataflow`` and ``ircheck`` import torch and the port
and are reached as submodules.
"""
from .lint import (Finding, known_rules, lint_file, lint_paths,  # noqa: F401
                   register_rule)

__all__ = ["Finding", "known_rules", "lint_file", "lint_paths",
           "register_rule"]
