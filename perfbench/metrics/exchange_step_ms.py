"""``exchange_step_ms``: the card's kernels and copies launched under the
program's exchange spans (``hpcg.exchange``, ``heat.exchange``) in the
spans window, their device time summed, over its app steps (HPCG: PCG
iterations), in ms.  Nothing off the card, or where a kernel's launch was
not found."""
from perfbench import span_window


def read(ctx):
    w = span_window.window(ctx)
    if w is None or not w.attributed or not w.steps:
        return None
    device_s, launches, _ = span_window.device_under(w, span_window.EXCHANGE)
    return 1e3 * device_s / w.steps if launches else None
