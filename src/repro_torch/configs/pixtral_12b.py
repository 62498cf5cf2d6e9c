"""pixtral-12b — [vlm] mistral-nemo decoder backbone; the pixtral-ViT
frontend is a STUB (callers pass precomputed patch embeddings).
[hf:mistralai/Pixtral-12B-2409; unverified]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=131072,
    rope_theta=1_000_000.0, norm="rmsnorm", act="swiglu",
    embedding_inputs=True,
)
