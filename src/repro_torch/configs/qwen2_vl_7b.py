"""Qwen2-VL-7B backbone.  [arXiv:2409.12191; hf] - 28L d_model=3584 28H
(GQA kv=4) d_ff=18944 vocab=152064; M-RoPE, dynamic resolution.

Modality frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings (embed_inputs=False); M-RoPE positions are
(t, h, w) triples."""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="qwen2-vl-7b", family="vlm", n_layers=28, d_model=3584,
    n_heads=28, n_kv_heads=4, d_ff=18944, vocab_size=152064,
    norm="rmsnorm", act="swiglu", rope_theta=1e6, mrope=True,
    embed_inputs=False,
    source="arXiv:2409.12191; hf",
)

SMOKE = ArchConfig(
    name="qwen2-vl-7b-smoke", family="vlm", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=2, d_ff=256, vocab_size=512, mrope=True,
    embed_inputs=False, head_dim=128,
)
