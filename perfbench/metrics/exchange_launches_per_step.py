"""``exchange_launches_per_step``: the card's kernels and copies launched
under the program's exchange spans (``hpcg.exchange``, ``heat.exchange``)
in the spans window, over its app steps.  Nothing off the card, or where a
kernel's launch was not found."""
from perfbench import span_window


def read(ctx):
    w = span_window.window(ctx)
    if w is None or not w.attributed or not w.steps:
        return None
    _, launches, _ = span_window.device_under(w, span_window.EXCHANGE)
    return launches / w.steps if launches else None
