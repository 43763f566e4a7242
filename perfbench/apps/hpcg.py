"""The HPCG cells' app: the port's multigrid-preconditioned CG
(``repro_torch.apps.hpcg.torch_impl.make_cg``) on z-slab ranks stacked on
one device.

Inputs: one right-hand side ``b``, standard normal from the seed in the
configuration's dtype, and ``x0 = 0``.  A unit of work is one set: a solve
of ``iterations`` PCG iterations from ``x0``, all sets alike, back to
back.  The check solves the same system with the plain reference in
float64 on the whole lattice, and holds every set's residual norm and the
last set's solution to it.
"""
from __future__ import annotations

from perfbench import counts
from perfbench.reference import hpcg as reference


class App:
    """``dtype``, where given, is the precision the program runs in (the
    control's); the inputs are made in the configuration's."""

    def __init__(self, torch, cfg: dict, traffic: dict, seed: int,
                 device: str, dtype=None):
        from repro_torch.apps.hpcg import torch_impl
        from repro_torch.comm.topology import grid_mesh
        from repro_torch.kernels.halo_exchange import ops as halo_ops
        self.torch, self.impl, self.halo_ops = torch, torch_impl, halo_ops
        self.device = torch.device(device)
        self.seed = seed
        self.ranks, self.levels = cfg["ranks"], cfg["levels"]
        self.iterations = cfg["iterations"]
        self.slab = (cfg["nz"], cfg["ny"], cfg["nx"])
        self.shape = (self.ranks * self.slab[0], *self.slab[1:])
        #: The configuration's dtype, whose peak rate the bounds take.
        self.peak_dtype = cfg["dtype"]
        self.input_dtype = getattr(torch, cfg["dtype"])
        self.dtype = self.input_dtype if dtype is None else dtype
        self.backend = traffic["backend"]
        self.trace_units = traffic["trace_sets"]
        self.grid = grid_mesh(self.ranks, device=device)
        self.solve = torch_impl.make_cg(self.grid, self.backend,
                                        n_iter=self.iterations)
        self._warm = torch_impl.make_cg(self.grid, self.backend,
                                        n_iter=traffic["warmup_iterations"])
        self.x, self.res = None, []
        #: The halo kernel's launches in each set, by the program's counter.
        self.halo_launches = []
        itemsize = self.dtype.itemsize
        points = self.ranks * self.slab[0] * self.slab[1] * self.slab[2]
        self.step_least_s = counts.least_s(
            counts.hpcg_step_bytes(points, itemsize),
            counts.hpcg_step_ops(self.slab, self.ranks, self.levels),
            self.peak_dtype)
        self.probes = {}

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def _rhs(self):
        """``b`` from the seed, in the configuration's dtype."""
        torch = self.torch
        g = torch.Generator(device=self.device).manual_seed(self.seed)
        return torch.randn(self.shape, generator=g, device=self.device,
                           dtype=self.input_dtype)

    def setup(self):
        self.b = self._rhs().to(self.dtype)
        self.x0 = self.torch.zeros_like(self.b)
        x, res = self._warm(self.b, self.x0)
        self.sync()
        del x, res
        slabs = self.impl.to_slabs(self.b, self.ranks)
        itemsize = self.dtype.itemsize
        self.probes["apply_a"] = (
            lambda: self.impl.apply_a(slabs, self.backend),
            counts.least_s(
                counts.apply_a_bytes(self.ranks, self.slab, itemsize),
                counts.apply_a_ops(self.ranks, self.slab), self.peak_dtype))

    def unit(self) -> int:
        """Enqueue one set; returns its PCG iterations."""
        before = self.halo_ops.ring_halo_exchange.launches
        self.x, res = self.solve(self.b, self.x0)
        self.res.append(res)
        self.halo_launches.append(
            self.halo_ops.ring_halo_exchange.launches - before)
        return self.iterations

    def halo_bound_s(self, sets: int) -> float:
        """The least time of the halo kernel's launches in ``sets`` sets:
        each launch's planes read once and written once, at its level."""
        slabs = counts.hpcg_slabs(self.slab, self.levels)
        per_set = counts.hpcg_applies_per_set(self.iterations, len(slabs))
        nbytes = sum(c * counts.halo_bytes(self.ranks, s[1] * s[2],
                                           self.dtype.itemsize)
                     for c, s in zip(per_set, slabs))
        return sets * nbytes / counts.HBM_BYTES_S

    def halo_launches_expected(self, sets: int) -> int:
        slabs = counts.hpcg_slabs(self.slab, self.levels)
        return sets * sum(counts.hpcg_applies_per_set(self.iterations,
                                                      len(slabs)))

    def finish(self):
        """Free the program's state but the outputs the check reads."""
        del self.b, self.x0, self.solve, self._warm, self.grid
        self.probes.clear()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def check(self, limits: dict) -> tuple:
        """The last set's solution and every set's residual norm against
        the reference's float64 solve of the same system: the largest
        pointwise gap over the largest |x|, and the residual norms'
        relative gap."""
        torch = self.torch
        f64 = torch.float64
        b = self._rhs().to(f64)
        x_ref, res_ref = reference.pcg(b, self.ranks, self.levels,
                                       self.iterations)
        del b
        x_err = float((self.x.to(f64) - x_ref).abs().max()
                      / x_ref.abs().max())
        del x_ref
        res_ref = float(res_ref)
        res = torch.stack(self.res).to(f64).cpu().tolist()
        res_errs = [abs(r - res_ref) / res_ref for r in res]
        lim_x, lim_r = limits["x_err"], limits["res_err"]
        failed = sum(not e <= lim_r for e in res_errs[:-1]) \
            + (not (res_errs[-1] <= lim_r and x_err <= lim_x))
        worst = float("nan") if any(e != e for e in res_errs) \
            else max(res_errs)
        return ({"x_err": (x_err, lim_x), "res_err": (worst, lim_r)},
                len(res), failed)


# Faults planted in the timed path, each of which a check must catch:
# ``plant(app, mp)`` with ``mp`` a ``pytest.MonkeyPatch``.

def _state_unchanged(app, mp):
    """Every set returns ``x0``: a solve of no iterations."""
    mp.setattr(app, "solve", app.impl.make_cg(app.grid, app.backend,
                                              n_iter=0))


def _half_batch(app, mp):
    """Every dot over the first half of the ranks, scaled to all."""
    torch = app.torch

    def half(a, b):
        n = a.shape[0] // 2
        part = torch.linalg.vecdot(a[:n].reshape(n, -1),
                                   b[:n].reshape(n, -1))
        return part.sum() * (a.shape[0] / n)
    mp.setattr(app.impl, "_pdot", half)


def _no_exchange(app, mp):
    """Ghost planes of zeros in place of the neighbours' planes."""
    def zeros(blocks):
        return (app.torch.zeros_like(blocks[:, :1]),
                app.torch.zeros_like(blocks[:, :1]))
    mp.setitem(app.impl._EXCHANGE, app.backend, zeros)


def _answer_altered(app, mp):
    """One value of every set's solution raised by 1."""
    unit = app.unit

    def altered():
        steps = unit()
        app.x.view(-1)[123] += 1.0
        return steps
    mp.setattr(app, "unit", altered)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "no_exchange": _no_exchange, "answer_altered": _answer_altered}
