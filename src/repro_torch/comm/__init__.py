"""Halo exchange between stacked ranks: message-based (ppermute-style
copies) and message-free (a shared boundary window); ``collectives`` holds
the collectives of stacked ranks as custom ops a capture records, and
``counters`` the exchanges' calls and bytes."""
from . import collectives, counters, message_based, message_free
from .topology import RankGrid, grid_mesh, shift_perm

__all__ = ["collectives", "counters", "message_based", "message_free",
           "RankGrid", "grid_mesh", "shift_perm"]
