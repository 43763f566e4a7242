"""internvl2-2b — InternViT frontend (stub) + InternLM2 backbone
[arXiv:2404.16821; hf].  The vision tower is a stub per the assignment:
the batch carries precomputed patch embeddings (frontend_dim = InternViT
hidden size)."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab_size=92553, vocab_pad=92672 - 92553,
    frontend="vision", frontend_dim=1024, img_seq=1024)
