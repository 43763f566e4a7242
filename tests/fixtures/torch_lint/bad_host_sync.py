"""Lint fixture: host syncs inside a custom op body and a hot step."""
import torch


@torch.library.custom_op("fixture::scaled", mutates_args=())
def scaled(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return x * s.item()


def decode_step(caches, batch, pos):
    torch.cuda.synchronize()
    return caches, int(pos)


def cold(x):
    return x.item()                           # not a hot path: fine
