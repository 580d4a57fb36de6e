"""StableLM-2-family dense transformer.  [hf:stabilityai/stablelm-2-1_6b;
unverified] - 32L d_model=2560 32H (GQA kv=32 == MHA) d_ff=6912 vocab=50304.
LayerNorm + SwiGLU per the StableLM-2 report."""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="stablelm-3b", family="dense", n_layers=32, d_model=2560,
    n_heads=32, n_kv_heads=32, d_ff=6912, vocab_size=50304,
    norm="layernorm", act="swiglu", rope_theta=1e4,
    source="hf:stabilityai/stablelm-2-1_6b; unverified",
)

SMOKE = ArchConfig(
    name="stablelm-3b-smoke", family="dense", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=4, d_ff=256, vocab_size=512,
    norm="layernorm", act="swiglu",
)
