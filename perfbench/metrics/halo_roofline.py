"""``halo_roofline``: the port's halo kernel (``halo_*`` in the trace) over
the traced window: the sum of each launch's least time (its planes read
once and written once, at its V-cycle level) over the launches' summed
device time, in %.  Nothing where the window launched no halo kernel, or
where the trace kept fewer launches than the program's counter
(``ring_halo_exchange.launches``) and the counts expected."""

HALO = "halo_"


def read(ctx):
    tr, app = ctx.trace, ctx.app
    if tr is None or not hasattr(app, "halo_bound_s"):
        return None
    sets = app.trace_units
    launches = tr.count(HALO)
    if not launches or launches != sum(app.halo_launches[-sets:]) \
            or launches != app.halo_launches_expected(sets):
        return None
    return 100.0 * app.halo_bound_s(sets) / tr.device_s(HALO)
