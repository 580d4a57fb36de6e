"""Phi-4-mini dense transformer.  [arXiv:2412.08905; hf] -
32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064, RoPE SwiGLU GQA."""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="phi4-mini-3.8b", family="dense", n_layers=32, d_model=3072,
    n_heads=24, n_kv_heads=8, d_ff=8192, vocab_size=200064,
    norm="rmsnorm", act="swiglu", rope_theta=1e4,
    source="arXiv:2412.08905; hf",
)

SMOKE = ArchConfig(
    name="phi4-mini-3.8b-smoke", family="dense", n_layers=2, d_model=96,
    n_heads=6, n_kv_heads=2, d_ff=192, vocab_size=512,
)
