"""``python -m repro_torch.lint [paths]``: the CLI of the port's AST
linter.  The engine and the rule registry live in
:mod:`repro_torch.analysis.lint`; this module only gives the CLI the
spelling of the JAX package's (``python -m repro.lint``)."""
from .analysis.lint import main

if __name__ == "__main__":
    raise SystemExit(main())
