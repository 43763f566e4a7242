"""``peak_gb``: ``torch.cuda.max_memory_allocated()`` over set-up and the
window, in units of 1e9 bytes (nothing off the card)."""


def read(ctx):
    return None if ctx.peak_bytes is None else ctx.peak_bytes / 1e9
