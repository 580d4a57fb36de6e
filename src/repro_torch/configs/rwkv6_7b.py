"""RWKV-6 "Finch" 7B (attention-free).  [arXiv:2404.05892; hf] -
32L d_model=4096 d_ff=14336 vocab=65536; data-dependent decay."""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="rwkv6-7b", family="ssm", n_layers=32, d_model=4096,
    n_heads=64, n_kv_heads=64, d_ff=14336, vocab_size=65536,
    block="rwkv", norm="layernorm", act="relu2",
    source="arXiv:2404.05892; hf",
)

SMOKE = ArchConfig(
    name="rwkv6-7b-smoke", family="ssm", n_layers=2, d_model=128,
    n_heads=2, n_kv_heads=2, d_ff=256, vocab_size=512,
    block="rwkv", norm="layernorm",
)
