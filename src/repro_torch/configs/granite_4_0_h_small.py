"""granite-4.0-h-small — IBM Granite 4.0-H Small, 32B-A9B, hybrid Mamba-2 +
attention 9:1, a 72-expert top-10 MoE with one shared expert in every layer
[hf:ibm-granite/granite-4.0-h-small config.json, ``granitemoehybrid``].

``layer_types`` puts attention at layers 5, 15, 25 and 35: a period of 10
with attention at offset 5.  Attention is GQA 32 / 8 with no positional
encoding (``position_embedding_type`` "nope") and a softmax scale of
``attention_multiplier`` 1/128.  Mamba-2: 128 heads of 64 channels
(d_inner 8192 = 2 x 4096), d_state 128, one group, conv 4, chunk 256.
Each layer adds 0.22 x its mixer and 0.22 x (MoE + shared expert) to the
residual; the embedding is scaled by 12 and the tied head's logits divided
by 16.  The port alone runs it (``ArchConfig.port_only``)."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-4.0-h-small", family="hybrid",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=768, vocab_size=100352, tie_embeddings=True, norm_eps=1e-5,
    n_experts=72, experts_per_token=10, moe_dropless=True, shared_ff=1536,
    ssm_state=128, ssm_conv=4, ssm_expand=2,
    ssm_version=2, ssm_heads=128, ssm_head_dim=64, ssm_groups=1,
    ssm_chunk=256,
    attn_period=10, attn_offset=5,
    rope=False, attn_scale=0.0078125,
    embedding_multiplier=12.0, residual_multiplier=0.22, logits_scaling=16.0)
