"""MusicGen-medium decoder backbone.  [arXiv:2306.05284; hf] -
48L d_model=1536 24H (kv=24) d_ff=6144 vocab=2048 (EnCodec codebook).

Modality frontend is a STUB per the assignment: the EnCodec tokenizer +
codebook-delay interleaving produce frame embeddings offline;
``input_specs()`` feeds precomputed [B, S, d_model] frames
(embed_inputs=False).  Decode emits one EnCodec code per step."""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="musicgen-medium", family="audio", n_layers=48, d_model=1536,
    n_heads=24, n_kv_heads=24, d_ff=6144, vocab_size=2048,
    norm="layernorm", act="gelu", rope_theta=1e4, embed_inputs=False,
    source="arXiv:2306.05284; hf",
)

SMOKE = ArchConfig(
    name="musicgen-medium-smoke", family="audio", n_layers=2, d_model=96,
    n_heads=4, n_kv_heads=4, d_ff=192, vocab_size=256,
    norm="layernorm", act="gelu", embed_inputs=False,
)
