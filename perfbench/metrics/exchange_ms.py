"""``exchange_ms``: the heat app's halo exchange (``exchange_halos_2d`` of
the cell's backend) alone at the cell's tiles: the card's operations a
call, summed from a traced window of :data:`CALLS` calls in a row, in ms."""
from perfbench import tracing

CALLS = 200


def read(ctx):
    probe = ctx.app.probes.get("exchange_halos_2d")
    if probe is None or not ctx.on_card:
        return None
    return 1e3 * tracing.device_s_per_call(ctx.torch, probe[0], CALLS)
