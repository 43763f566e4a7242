"""The heat cells' app: the port's 2D heat-transfer step
(``repro_torch.apps.stencil.torch_impl.make_step``) on a ``px x py`` grid of
ranks stacked on one device.

Input: the plane's ``(px, py, tile, tile)`` tiles, uniform in [0, 1) from
the seed; tile ``(i, j)`` holds the plane's rows ``i tile ...`` and columns
``j tile ...``.  A unit of work is one step, the window's steps back to
back from that plane (the warm-up steps a copy and is thrown away).

The check holds the plane after the window's ``n`` steps to the plain
reference in float64, on patches sampled from the seed: one about every
fourth tile corner, so that the patches touch every tile, one about the
middle of each of the two tile edges that end there from above and from
the left, one at each of the plane's corners, and one where a tile
boundary meets each edge; each patch is worked out from its ``n``-step
neighbourhood of the initial plane.
It also holds the plane's total heat, which insulating edges keep, to the
initial plane's: a value altered anywhere shows there.
"""
from __future__ import annotations

from perfbench import counts
from perfbench.reference import heat2d as reference


class App:
    """``dtype``, where given, is the precision the program runs in (the
    control's); the initial plane is made in the configuration's."""

    def __init__(self, torch, cfg: dict, traffic: dict, seed: int,
                 device: str, dtype=None):
        from repro_torch.apps.stencil import torch_impl
        from repro_torch.comm import message_based, message_free
        from repro_torch.comm.topology import grid_mesh
        self.torch = torch
        self.device = torch.device(device)
        self.seed = seed
        self.px, self.py = cfg["px"], cfg["py"]
        self.tile = traffic["tile"]
        self.input_dtype = getattr(torch, cfg["dtype"])
        self.dtype = self.input_dtype if dtype is None else dtype
        self.backend = traffic["backend"]
        self.warmup_steps = traffic["warmup_steps"]
        self.trace_units = traffic["trace_steps"]
        self.patch, self.jitter = traffic["check_patch"], \
            traffic["check_jitter"]
        self.step = torch_impl.make_step(grid_mesh(self.px, self.py,
                                                   device=device),
                                         self.backend)
        #: The exchange's module, as ``make_step`` picks it.
        self.comm = (message_free if self.backend == "message_free"
                     else message_based)
        self.steps = 0
        points = self.px * self.py * self.tile ** 2
        self.step_least_s = counts.least_s(
            counts.heat_step_bytes(points, self.dtype.itemsize),
            counts.heat_step_ops(points), cfg["dtype"])
        self.probes = {}

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def _initial(self):
        """The initial tiles from the seed, in the configuration's dtype."""
        torch = self.torch
        g = torch.Generator(device=self.device).manual_seed(self.seed)
        return torch.rand((self.px, self.py, self.tile, self.tile),
                          generator=g, device=self.device,
                          dtype=self.input_dtype)

    def setup(self):
        self.tiles = self._initial().to(self.dtype)
        t = self.tiles
        for _ in range(self.warmup_steps):
            t = self.step(t)
        self.sync()
        del t
        self.probes["exchange_halos_2d"] = (
            lambda: self.comm.exchange_halos_2d(self.tiles), None)

    def unit(self) -> int:
        self.tiles = self.step(self.tiles)
        self.steps += 1
        return 1

    def finish(self):
        self.probes.clear()
        del self.step
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def _at(self, tiles, rows, cols):
        """The plane's points ``rows x cols`` (``(B, L)`` each) read from
        its tiles: ``(B, L, L)``."""
        t = self.tile
        return tiles[(rows // t)[:, :, None], (cols // t)[:, None, :],
                     (rows % t)[:, :, None], (cols % t)[:, None, :]]

    def corners(self):
        """Top-left corners ``(B, 2)`` of the sampled patches."""
        torch, t, p = self.torch, self.tile, self.patch
        H, W = self.px * t, self.py * t
        points = [((2 * a + 1) * t - da, (2 * b + 1) * t - db)
                  for a in range((self.px + 1) // 2)
                  for b in range((self.py + 1) // 2)
                  for da, db in ((0, 0), (0, t // 2), (t // 2, 0))]
        points += [(r, c) for r in (0, H) for c in (0, W)]
        points += [(0, self.py // 2 * t), (H, self.py // 2 * t),
                   (self.px // 2 * t, 0), (self.px // 2 * t, W)]
        g = torch.Generator().manual_seed(self.seed)
        shift = torch.randint(-self.jitter, self.jitter + 1,
                              (len(points), 2), generator=g)
        at = torch.tensor(points) - p // 2 + shift
        at[:, 0].clamp_(0, H - p)
        at[:, 1].clamp_(0, W - p)
        return at.to(self.device)

    def _heat(self, tiles) -> float:
        f64 = self.torch.float64
        return sum(float(row.sum(dtype=f64)) for row in tiles)

    def check(self, limits: dict) -> tuple:
        """The patches' largest gap from the reference, and the total
        heat's drift relative to the initial plane's."""
        torch = self.torch
        tiles = self.tiles
        n, p = self.steps, self.patch
        shape = (self.px * self.tile, self.py * self.tile)
        start = self._initial()
        at = self.corners()
        rows, cols = reference.region_indices(at, p, n, shape)
        want = reference.patches(self._at(start, rows, cols)
                                 .to(torch.float64), n)
        span = torch.arange(p, device=self.device)
        got = self._at(tiles, at[:, :1] + span, at[:, 1:] + span)
        errs = (got.to(torch.float64) - want).abs().amax(dim=(1, 2))
        heat0 = self._heat(start)
        drift = abs(self._heat(tiles) - heat0) / heat0
        lim_p, lim_m = limits["patch_err"], limits["heat_drift"]
        failed = int((~(errs <= lim_p)).sum()) + (not drift <= lim_m)
        return ({"patch_err": (float(errs.max()), lim_p),
                 "heat_drift": (drift, lim_m)},
                len(errs) + 1, failed)


# Faults planted in the timed path, each of which a check must catch:
# ``plant(app, mp)`` with ``mp`` a ``pytest.MonkeyPatch``.

def _state_unchanged(app, mp):
    """Every step returns its tiles."""
    mp.setattr(app, "step", lambda tiles: tiles)


def _half_batch(app, mp):
    """Only the first row of ranks steps; the others keep their tiles."""
    step = app.step

    def half(tiles):
        return app.torch.cat([step(tiles)[:1], tiles[1:]])
    mp.setattr(app, "step", half)


def _no_exchange(app, mp):
    """Every rank's halos are its own edges, as if each were alone."""
    def own_edges(tiles):
        return (tiles[:, :, :1, :].clone(), tiles[:, :, -1:, :].clone(),
                tiles[..., :1].clone(), tiles[..., -1:].clone())
    mp.setattr(app.comm, "exchange_halos_2d", own_edges)


def _answer_altered(app, mp):
    """One value of every step's plane raised by 1."""
    unit = app.unit

    def altered():
        steps = unit()
        app.tiles[1, 0, 3, 5] += 1.0
        return steps
    mp.setattr(app, "unit", altered)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "no_exchange": _no_exchange, "answer_altered": _answer_altered}
