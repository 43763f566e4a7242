"""jamba-v0.1-52b — hybrid Mamba+attention 1:7, MoE 16e top-2 every 2nd
layer [arXiv:2403.19887; hf].  Pattern period 8: attention at in-block
offset 3 (as in the reference implementation), MoE on odd layers."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=65536,
    n_experts=16, experts_per_token=2,
    ssm_state=16, ssm_conv=4, ssm_expand=2,
    attn_period=8, attn_offset=3, moe_period=2, moe_offset=1)
