"""Architecture and run configuration dataclasses (a copy of the
``ArchConfig`` and ``RunConfig`` of ``repro.configs.base``: the reference
module imports ``jax.numpy`` for its dtypes, so the port keeps its own,
whose :attr:`ArchConfig.dtype` is a torch dtype)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.analog import AnalogConfig
from repro_torch.core.noise import NoiseConfig


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    norm: str = "rmsnorm"
    act: str = "swiglu"
    rope_theta: float = 1e4
    mrope: bool = False              # Qwen2-VL multimodal RoPE
    embed_inputs: bool = True        # False: frontend stub feeds embeddings
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                # per-expert hidden dim
    n_shared_experts: int = 0
    moe_every: int = 1               # 2 -> interleaved dense/MoE (Llama-4)
    moe_dense_d_ff: int = 0          # d_ff of the interleaved dense layers
    # --- SSM / hybrid ---
    block: str = "attn"              # attn | rwkv | mamba
    ssm_state: int = 0
    attn_every: int = 0              # Zamba2: shared attn block every k layers
    # --- execution ---
    param_dtype: str = "float32"     # "bfloat16" for the 400B config
    remat: bool = True
    scan_layers: bool = True
    source: str = ""                 # provenance tag [hf/arXiv; tier]

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def dtype(self) -> torch.dtype:
        return (torch.bfloat16 if self.param_dtype == "bfloat16"
                else torch.float32)

    @property
    def attention_free(self) -> bool:
        return self.block in ("rwkv", "mamba") and self.attn_every == 0

    @property
    def supports_long_context(self) -> bool:
        """long_500k runs only for sub-quadratic (SSM/hybrid) backbones."""
        return self.block in ("rwkv", "mamba")

    def layer_kind(self, i: int) -> str:
        if self.block == "rwkv":
            return "rwkv"
        if self.block == "mamba":
            return "mamba"
        if self.n_experts and (i % self.moe_every == self.moe_every - 1):
            return "attn_moe"
        return "attn_mlp"

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once if tied)."""
        d, v = self.d_model, self.vocab_size
        total = v * d * (1 if self.tie_embeddings else 2)
        for i in range(self.n_layers):
            kind = self.layer_kind(i)
            if kind in ("attn_mlp", "attn_moe"):
                total += d * self.hd * (self.n_heads + 2 * self.n_kv_heads)
                total += self.n_heads * self.hd * d
                if kind == "attn_mlp":
                    ff = self.moe_dense_d_ff or self.d_ff
                    total += (3 if self.act == "swiglu" else 2) * d * ff
                else:
                    nm = 3 if self.act == "swiglu" else 2
                    total += self.n_experts * nm * d * self.moe_d_ff
                    total += d * self.n_experts  # router
                    if self.n_shared_experts:
                        total += nm * d * self.moe_d_ff * self.n_shared_experts
            elif kind == "rwkv":
                total += 5 * d * d + 2 * d * 64 + d * self.d_ff * 2
            elif kind == "mamba":
                d_in = 2 * d
                total += d * (2 * d_in + 2 * self.ssm_state + d_in // 64)
                total += d_in * d
        if self.attn_every:  # zamba2 shared attention block (one param set)
            total += d * self.hd * (self.n_heads + 2 * self.n_kv_heads)
            total += self.n_heads * self.hd * d
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        if not self.n_experts:
            return self.param_count()
        nm = 3 if self.act == "swiglu" else 2
        moe_layers = sum(1 for i in range(self.n_layers)
                         if self.layer_kind(i) == "attn_moe")
        inactive = moe_layers * nm * self.d_model * self.moe_d_ff * (
            self.n_experts - self.top_k)
        return self.param_count() - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input shape of the dry run's cells."""

    name: str
    seq_len: int
    global_batch: int
    kind: str              # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Execution knobs orthogonal to the architecture, with the
    reference's defaults: the analog backend, AdamW's, flash attention's
    blocks, the seed, int8 gradient compression, the MoE dispatch's
    ``capacity_factor`` and the distribution knobs (``fsdp``,
    ``seq_sp``, ``moe_dispatch``, ``attn_cp``).  The reference's
    ``optimizer`` name (AdamW is the only one) is not kept."""

    analog: AnalogConfig = dataclasses.field(
        default_factory=lambda: AnalogConfig(
            mode="digital", noise=NoiseConfig(mode="rank1")
        )
    )
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    optim_dtype: str = "float32"     # "bfloat16" halves optimizer memory
    flash_block_q: int = 256
    flash_block_kv: int = 512
    activation_dtype: str = "bfloat16"
    seed: int = 0
    grad_compression: bool = False
    capacity_factor: float = 1.25
    # --- distribution knobs (read under a mesh) ---
    fsdp: bool = True            # shard param embed dims over the data axis
    # the reference's sequence-parallel residual name: read by
    # sharding.rules_for only (no site of the port splits the residual)
    seq_sp: bool = True
    # shard_map = the explicit-collective expert-parallel dispatch; without
    # a mesh (or a model axis) it is the gspmd_ep path
    moe_dispatch: str = "shard_map"  # shard_map | gspmd_ep | replicated_buf
    attn_cp: str = "auto"            # context-parallel attn: auto | cp | off
