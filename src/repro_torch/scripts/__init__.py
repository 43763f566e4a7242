"""Offline tools over the port's dry-run records
(``experiments/dryrun_torch/``): ``refresh_fits`` and
``update_experiments``, run with ``python -m repro_torch.scripts.<name>``."""
