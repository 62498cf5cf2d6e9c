"""jamba-v0.1-52b — [hybrid] Mamba + attention 1:7 interleave, MoE 16e
top-2 every other layer. [arXiv:2403.19887; hf]"""
from ..models.config import ArchConfig, MambaSpec, MoESpec

CONFIG = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=65536,
    attn_every=8,                         # 1 attention : 7 mamba
    moe=MoESpec(n_experts=16, top_k=2, every=2),
    mamba=MambaSpec(d_state=16, d_conv=4, expand=2),
    rope_theta=10_000.0, norm="rmsnorm", act="swiglu",
)
