"""Halo exchange between stacked ranks: message-based (ppermute-style
copies) and message-free (a shared boundary window)."""
from . import message_based, message_free
from .topology import RankGrid, grid_mesh, shift_perm

__all__ = ["message_based", "message_free", "RankGrid", "grid_mesh",
           "shift_perm"]
