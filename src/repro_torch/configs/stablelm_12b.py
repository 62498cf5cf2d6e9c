"""stablelm-12b — dense decoder with GQA. [hf:stabilityai/stablelm-2-12b; hf]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=13824, vocab=100352,
    rope_theta=10_000.0, norm="layernorm", act="swiglu",
)
