"""Llama-4-Maverick-400B-A17B MoE.  [hf:meta-llama/Llama-4-Scout-17B-16E;
unverified] - 48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048,
MoE 128 experts top-1.

Config-level assumption (the reference's): 128-expert top-1 MoE in *every*
layer would be ~770B params; Llama-4 interleaves dense/MoE 1:1 with a shared
expert, which lands at ~400B total / ~17B active, matching the name.
Parameters are bf16 (``param_dtype``), as in the reference config."""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe", n_layers=48,
    d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128, d_ff=8192,
    vocab_size=202048, n_experts=128, top_k=1, moe_d_ff=8192,
    moe_every=2, moe_dense_d_ff=8192, n_shared_experts=1,
    norm="rmsnorm", act="swiglu", rope_theta=5e5,
    param_dtype="bfloat16",
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)

SMOKE = ArchConfig(
    name="llama4-maverick-400b-a17b-smoke", family="moe", n_layers=2,
    d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=512,
    n_experts=4, top_k=1, moe_d_ff=64, moe_every=2, moe_dense_d_ff=128,
    n_shared_experts=1,
)
