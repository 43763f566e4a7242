"""``setup_s``: host-clock seconds from the start of ``run.py`` to the
window: imports, the card's context, loading (or, in a checkout's first
run, building) the port's CUDA libraries, making the inputs and the
warm-up."""


def read(ctx):
    return ctx.setup_s
