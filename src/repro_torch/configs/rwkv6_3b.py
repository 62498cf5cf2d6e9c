"""rwkv6-3b (Finch) — [ssm] attention-free, data-dependent decay linear
attention. [arXiv:2404.05892; hf]"""
from ..models.config import ArchConfig, RWKVSpec

CONFIG = ArchConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=0, n_kv_heads=0,
    d_ff=8960, vocab=65536,
    rwkv=RWKVSpec(head_size=64, decay_lora=64, mix_lora=32),
    norm="layernorm",
)
