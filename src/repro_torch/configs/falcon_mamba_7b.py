"""falcon-mamba-7b — pure Mamba-1, attention-free [arXiv:2410.05355]."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=65024,
    ssm_state=16, ssm_conv=4, ssm_expand=2)
