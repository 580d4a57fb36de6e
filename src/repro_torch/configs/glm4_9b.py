"""GLM-4-9B dense transformer.  [hf:THUDM/glm-4-9b; hf] -
40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552, RoPE."""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="glm4-9b", family="dense", n_layers=40, d_model=4096,
    n_heads=32, n_kv_heads=2, d_ff=13696, vocab_size=151552,
    norm="rmsnorm", act="swiglu", rope_theta=1e4,
    source="hf:THUDM/glm-4-9b; hf",
)

SMOKE = ArchConfig(
    name="glm4-9b-smoke", family="dense", n_layers=2, d_model=128,
    n_heads=8, n_kv_heads=2, d_ff=384, vocab_size=512,
)
