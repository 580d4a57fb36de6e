"""Qwen3-30B-A3B MoE.  [hf:Qwen/Qwen3-30B-A3B; hf] - 48L d_model=2048 32H
(GQA kv=4, head_dim=128) per-expert d_ff=768, vocab=151936,
128 experts top-8 in every layer."""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=32, n_kv_heads=4, head_dim=128, d_ff=768, vocab_size=151936,
    n_experts=128, top_k=8, moe_d_ff=768, moe_every=1,
    norm="rmsnorm", act="swiglu", rope_theta=1e6,
    source="hf:Qwen/Qwen3-30B-A3B; hf",
)

SMOKE = ArchConfig(
    name="qwen3-moe-30b-a3b-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=32, d_ff=32, vocab_size=512,
    n_experts=8, top_k=2, moe_d_ff=32, moe_every=1,
)
