"""``exchange_bytes_per_step``: the bytes every exchange of the spans
window returned, summed over ranks, by the program's counters
(``repro_torch.comm.counters``), over its app steps, in 1e6 B.  Read on
the CPU too; nothing where the program counts no exchange."""
from perfbench import span_window


def read(ctx):
    w = span_window.window(ctx)
    if w is None or not w.steps or not w.counted:
        return None
    return sum(b for _, b in w.counted.values()) / (w.steps * 1e6)
