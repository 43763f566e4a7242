"""Lint fixture: real violations silenced by ``# repro_torch: noqa``."""
import torch

torch.set_default_dtype(torch.float64)  # repro_torch: noqa -- fixture
LIB = torch.cuda.is_available()  # repro_torch: noqa[import-time-build]
