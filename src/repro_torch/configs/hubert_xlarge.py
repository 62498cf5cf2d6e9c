"""hubert-xlarge — [audio] encoder-only transformer backbone; the conv
feature-extractor frontend is a STUB (callers pass precomputed
frame embeddings). [arXiv:2106.07447; unverified]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge", family="encoder",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
    d_ff=5120, vocab=504,
    causal=False, norm="layernorm", act="gelu",
    embedding_inputs=True,
    vocab_pad_to=128,         # 504 -> 512 (model-axis divisibility)
)
