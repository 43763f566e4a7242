"""Launch plans: the geometry of one kernel launch, in one place.

Each CUDA launcher computes its launch geometry (grid, block, dynamic
shared memory, cluster dims, cooperative or not) in one host function of
its source, which the launcher itself calls and which the source also
exports as ``<entry>_plan_<sfx>(shape args..., int* out)``.  Each kernel
package's ``ops.plan`` is the Python mirror of that function and returns a
:class:`LaunchPlan`; where the C side asks the card (the bracket kernel's
SM count and occupancy, the halo kernel's co-resident CTAs) the mirror
takes that value as an input.  ``<entry>_attrs_<sfx>(variant, smem, out)``
reports what only the card knows: ``cudaFuncGetAttributes`` of the
instantiation the launcher uses for ``variant`` and its occupancy at
``smem`` bytes of dynamic shared memory.

:func:`limits` holds a plan against what an H100 refuses (the analysis
tier's ``kernelcheck`` reports the same checks); :func:`refuse_grid` is
the wrappers' guard, raising before a launch the card would refuse.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math

#: What an H100 (sm_90) accepts for one launch.
MAX_THREADS = 1024
MAX_GRID_X = 2**31 - 1
MAX_GRID_YZ = 65535
MAX_SMEM = 232_448              # 227 KB of dynamic + static a block
MAX_STATIC_SMEM = 48 * 1024
MAX_CLUSTER = 8                 # portable cluster size
REGISTERS_PER_SM = 65_536
MAX_TMA_BOX = 256

#: ints written by ``<entry>_plan_<sfx>``: grid xyz, block xyz, dynamic
#: shared bytes, cluster xyz, cooperative.
PLAN_INTS = 11
#: ints written by ``<entry>_attrs_<sfx>``.
ATTRS = ("num_regs", "local_bytes", "static_smem", "max_threads",
         "max_dynamic_smem", "occupancy")


@dataclasses.dataclass(frozen=True)
class TmaMap:
    """One TMA tensor map a launcher encodes: ``dims`` innermost first,
    ``strides`` the byte strides of dims 1.. (dim 0 is contiguous), ``box``
    the elements copied per dim, ``elem`` bytes an element."""

    name: str
    dims: tuple
    strides: tuple
    box: tuple
    elem: int
    swizzle: int = 0            # bytes of the swizzle pattern, 0 for none


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """One launch's geometry.  ``as_ints`` is what the C side's plan
    function writes; ``static_smem`` (the kernel's ``__shared__``
    declarations), ``buffers`` (``(name, bytes, "dynamic" | "static")``,
    summing to ``smem`` and ``static_smem``), ``tma`` and
    ``thread_quantum`` (threads come in warps, or warpgroups) are the
    mirror's own, for the checks."""

    kernel: str
    grid: tuple
    block: tuple
    smem: int = 0
    cluster: tuple = (1, 1, 1)
    cooperative: bool = False
    static_smem: int = 0
    buffers: tuple = ()
    tma: tuple = ()
    thread_quantum: int = 32

    def as_ints(self) -> tuple:
        return (*self.grid, *self.block, int(self.smem), *self.cluster,
                int(self.cooperative))

    @property
    def threads(self) -> int:
        return math.prod(self.block)

    @property
    def ctas(self) -> int:
        return math.prod(self.grid)


def dim3(*xs) -> tuple:
    return tuple(int(x) for x in xs) + (1,) * (3 - len(xs))


def limits(plan: LaunchPlan, co_resident: int | None = None) -> list:
    """``[(check, ok, detail)]``: the plan against the card's limits.
    ``co_resident``: CTAs the card holds at once (a cooperative launch
    must fit)."""
    gx, gy, gz = plan.grid
    q = plan.thread_quantum
    cl = math.prod(plan.cluster)
    out = [
        ("grid positive", min(plan.grid) >= 1, f"grid {plan.grid}"),
        ("grid x within 2^31 - 1", gx <= MAX_GRID_X, f"{gx}"),
        ("grid y within 65535", gy <= MAX_GRID_YZ, f"{gy}"),
        ("grid z within 65535", gz <= MAX_GRID_YZ, f"{gz}"),
        ("threads per block within 1024", 1 <= plan.threads <= MAX_THREADS,
         f"{plan.threads}"),
        (f"threads a multiple of {q}", plan.threads % q == 0,
         f"{plan.threads} % {q}"),
        ("shared memory within 227 KB",
         plan.smem + plan.static_smem <= MAX_SMEM,
         f"{plan.smem} dynamic + {plan.static_smem} static <= {MAX_SMEM}"),
        ("static shared memory within 48 KB",
         plan.static_smem <= MAX_STATIC_SMEM, f"{plan.static_smem}"),
        ("cluster within 8", cl <= MAX_CLUSTER, f"cluster {plan.cluster}"),
        ("grid a whole number of clusters",
         all(g % c == 0 for g, c in zip(plan.grid, plan.cluster)),
         f"grid {plan.grid}, cluster {plan.cluster}"),
    ]
    if plan.cooperative:
        ok = co_resident is not None and plan.ctas <= co_resident
        out.append(("cooperative grid co-resident", ok,
                    f"{plan.ctas} CTAs, {co_resident} resident at once"))
    for m in plan.tma:
        out.append((f"TMA {m.name} strides 16-byte aligned",
                    all(s % 16 == 0 for s in m.strides),
                    f"strides {m.strides}"))
        out.append((f"TMA {m.name} box within 256",
                    all(1 <= b <= MAX_TMA_BOX for b in m.box),
                    f"box {m.box}"))
        inner = m.box[0] * m.elem
        out.append((f"TMA {m.name} inner box a 16-byte multiple",
                    inner % 16 == 0 and (not m.swizzle or inner <= m.swizzle),
                    f"{inner} B, swizzle {m.swizzle}"))
    return out


def refuse_grid(kernel: str, grid: tuple) -> None:
    """The wrappers' guard: raise ``ValueError`` before a launch whose grid
    the card refuses.  A call's shape moves only the grid (the block,
    shared memory and TMA boxes are fixed by the dtype and head width the
    routes check, and kernelcheck holds them); the guard is
    :func:`limits`'s grid checks, without building the rest of a plan on
    every call."""
    bad = [f"grid {axis} within 65535 ({g})"
           for axis, g in zip("yz", grid[1:]) if g > MAX_GRID_YZ]
    if bad:
        raise ValueError(f"{kernel}: the card refuses this launch: "
                         + "; ".join(bad))


def c_plan(fn, *args, n: int = PLAN_INTS) -> tuple:
    """Call a source's ``<entry>_plan_<sfx>`` and return its ``n`` ints
    (``PLAN_INTS``, and after them whatever that entry adds)."""
    out = (ctypes.c_int * n)()
    rc = fn(*args, ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"plan function failed: CUDA error {rc}")
    return tuple(out)


def c_attrs(fn, variant: int, smem: int) -> dict:
    """Call a source's ``<entry>_attrs_<sfx>``: the function attributes of
    ``variant``'s instantiation and its occupancy at ``smem``."""
    out = (ctypes.c_int * len(ATTRS))()
    rc = fn(int(variant), int(smem), ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"attrs function failed: CUDA error {rc}")
    return dict(zip(ATTRS, out))


__all__ = ["ATTRS", "LaunchPlan", "PLAN_INTS", "TmaMap", "c_attrs", "c_plan",
           "dim3", "limits", "refuse"]
