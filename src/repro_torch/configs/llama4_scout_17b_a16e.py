"""llama4-scout-17b-a16e — [moe] 16 experts top-1, early fusion (modality
frontend out of scope for the LM shapes). 40 heads does NOT divide the
16-way model axis: the sharding rules fall back to head_dim sharding
(DESIGN.md §5). [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from ..models.config import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202048,
    moe=MoESpec(n_experts=16, top_k=1, every=1),
    rope_theta=500_000.0, norm="rmsnorm", act="swiglu",
)
