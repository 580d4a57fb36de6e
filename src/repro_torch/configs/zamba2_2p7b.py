"""Zamba2-2.7B hybrid (Mamba2 + shared attention).  [arXiv:2411.15242; hf]
- 54L d_model=2560, shared attn 32H (kv=32), d_ff=10240, vocab=32000,
ssm_state=64.  Shared attention block applied every 6 Mamba2 layers with a
single (shared) parameter set."""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
    n_heads=32, n_kv_heads=32, d_ff=10240, vocab_size=32000,
    block="mamba", ssm_state=64, attn_every=6,
    norm="rmsnorm", act="gelu", rope_theta=1e4,
    source="arXiv:2411.15242; hf",
)

SMOKE = ArchConfig(
    name="zamba2-2.7b-smoke", family="hybrid", n_layers=4, d_model=128,
    n_heads=4, n_kv_heads=4, d_ff=256, vocab_size=512,
    block="mamba", ssm_state=16, attn_every=2,
)
