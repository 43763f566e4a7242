"""``operator_span_roofline``: HPCG's 27-point operator inside the timed
step: the summed least time of every ``apply_a`` of the spans window (x
read once with its ghost planes, y written once, at its level;
``perfbench.counts``) over the device time of the kernels and copies
launched under its ``hpcg.apply_a`` spans, in %.  Nothing off the card,
where a kernel's launch was not found, or where the window's
``hpcg.apply_a`` calls are not the count expected."""
from perfbench import span_window


def read(ctx):
    app = ctx.app
    if not hasattr(app, "halo_bound_s"):
        return None
    w = span_window.window(ctx)
    if w is None or not w.attributed:
        return None
    device_s, _, calls = span_window.device_under(w, [span_window.APPLY_A])
    expected, least_s = span_window.apply_a_expected(app, app.trace_units)
    if calls != expected or not device_s:
        return None
    return 100.0 * least_s / device_s
