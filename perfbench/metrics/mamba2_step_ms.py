"""``mamba2_step_ms``: the card's kernels launched under ``lm.mamba2``
(the Mamba-2 mixers, each with its projections, conv, state update and
gated norm) in the spans window, their device time summed, over its
decode steps, in ms.  Nothing off the card, or where a kernel's launch was
not found or no kernel ran there."""
from perfbench import span_window

SPAN = "lm.mamba2"


def read(ctx):
    w = span_window.window(ctx)
    if w is None or not w.attributed or not w.steps:
        return None
    device_s, launches, _ = span_window.device_under(w, [SPAN])
    return 1e3 * device_s / w.steps if launches else None
