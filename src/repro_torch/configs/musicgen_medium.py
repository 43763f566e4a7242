"""musicgen-medium — decoder-only over EnCodec tokens [arXiv:2306.05284].
The EnCodec frontend is a stub: the batch carries precomputed frame
embeddings (4 codebooks x 128-d latents = 512); the head predicts all 4
codebooks per frame."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab_size=2048,
    frontend="audio", frontend_dim=512, n_codebooks=4)
