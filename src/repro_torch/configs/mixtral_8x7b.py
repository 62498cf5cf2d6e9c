"""mixtral-8x7b — [moe] 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]"""
from ..models.config import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000,
    window=4096,                          # SWA -> sub-quadratic long ctx
    moe=MoESpec(n_experts=8, top_k=2, every=1),
    rope_theta=1_000_000.0, norm="rmsnorm", act="swiglu",
)
