"""Lint fixture: a compile and a capture per loop iteration."""
import torch

from repro_torch.core import graph


def run(model, batches):
    outs = []
    for b in batches:
        outs.append(torch.compile(model)(b))
        graph.capture(model, b)
    return outs
