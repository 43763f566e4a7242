"""The paper's applications as access-stream specs for ``repro_torch.memsim``."""
