"""minitron-8b — pruned nemotron dense decoder. [arXiv:2407.14679; hf]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=16384, vocab=256000,
    rope_theta=10_000.0, norm="rmsnorm", act="gelu",
)
