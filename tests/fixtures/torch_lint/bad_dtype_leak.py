"""Lint fixture: process-wide dtype and TF32 switches left set."""
import torch

torch.set_default_dtype(torch.float64)


def fast():
    torch.backends.cuda.matmul.allow_tf32 = True
