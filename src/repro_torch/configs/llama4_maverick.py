"""llama4-maverick-400b-a17b — MoE 128e top-1, early fusion
[hf:meta-llama/Llama-4; unverified].  MoE layers interleave with dense
layers (every 2nd, as in the production model — this is what lands the
total at ~400B); the shared expert is folded into the dense path (DESIGN.md
§Arch-applicability), so active params are ~13B vs the advertised 17B."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab_size=202048,
    n_experts=128, experts_per_token=1,
    moe_period=2, moe_offset=1)
