"""Minitron-4B (pruned Nemotron).  [arXiv:2407.14679; hf] -
32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000; squared-ReLU MLP."""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="minitron-4b", family="dense", n_layers=32, d_model=3072,
    n_heads=24, n_kv_heads=8, d_ff=9216, vocab_size=256000,
    norm="layernorm", act="relu2", rope_theta=1e4,
    source="arXiv:2407.14679; hf",
)

SMOKE = ArchConfig(
    name="minitron-4b-smoke", family="dense", n_layers=2, d_model=96,
    n_heads=6, n_kv_heads=2, d_ff=256, vocab_size=512,
    norm="layernorm", act="relu2",
)
