"""``mamba2_state_roofline``: the Mamba-2 decode's state update and
readout inside the timed step: the least time of every ``lm.mamba2.state``
call of the spans window (the float32 state read once and written once,
x, dt, B and C in and y out; ``perfbench.lm_counts``) over the device time
of the kernels launched under those spans, in %.  Nothing off the card,
where a kernel's launch was not found, or where the window's calls are
not the layers' count (Mamba-2 layers x steps x units)."""
from perfbench import span_window

SPAN = "lm.mamba2.state"


def read(ctx):
    app = ctx.app
    if not hasattr(app, "mamba2_state_least_s"):
        return None
    w = span_window.window(ctx)
    if w is None or not w.attributed:
        return None
    device_s, _, calls = span_window.device_under(w, [SPAN])
    if calls != app.mamba2_state_calls(app.trace_units) or not device_s:
        return None
    return 100.0 * app.mamba2_state_least_s(app.trace_units) / device_s
