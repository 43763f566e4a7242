"""``moe_span_roofline``: the MoE layers inside the timed decode step: the
least time of their weights' bytes (each layer's experts each touched
once, its shared expert and its router, a step; ``perfbench.lm_counts``)
over the device time of the kernels launched under ``lm.moe`` in the
spans window, in %.  Nothing off the card, where a kernel's launch was
not found, or where the window's ``lm.moe`` calls are not the layers x
steps x units."""
from perfbench import span_window

SPAN = "lm.moe"


def read(ctx):
    app = ctx.app
    if not hasattr(app, "moe_least_s"):
        return None
    w = span_window.window(ctx)
    if w is None or not w.attributed:
        return None
    device_s, _, calls = span_window.device_under(w, [SPAN])
    units = app.trace_units
    if calls != app.c["n_layers"] * app.steps * units or not device_s:
        return None
    return 100.0 * app.moe_least_s(units) / device_s
