"""Plain PyTorch reference of the served analog language model.

It computes what ``ServeEngine`` serves, from the master tensors that the
benchmark draws (``harness/weights.py``), with no code of the program:

- the bake: 6-bit weight codes ``clip(round(w / w_scale), -63, 63)``, the
  effective weights ``(codes * col_gain) * row_gain`` (the rank-1 fixed
  pattern), the per-(chunk, column) ADC offsets;
- every parameter matmul as the signed split of the BrainScaleS-2 VMM:
  one activation LSB per call from the abs-max of the whole batch, 5-bit
  codes of the positive and of the negative part, per 128-row chunk
  ``clip(round(gain * (a_c @ w_c) + offset_c), -128, 127)``, the chunk
  readouts summed, the negative pass subtracted, then dequantized;
- the float glue in the activation dtype that the configuration states
  (bfloat16 between layers, every reduction in float32): RMSNorm, RoPE,
  grouped-query attention through a float32 KV cache of ``max_len``
  positions, SwiGLU, the residual stream, the lm_head.

A group of requests is replayed as the engine runs it: the left-padded
prompts in one prefill (pad id 0, attended like any token), then one
decode step per further served token, fed the served tokens.  The batch
is replayed whole because the activation LSB of every layer is taken
over the whole batch.  The replay runs free (:meth:`ReferenceLM.steps`)
or a layer at a time on given residual streams (:meth:`ReferenceLM.layer`,
:meth:`ReferenceLM.head`).  Products run in float32 with TF32 off
(``precision="fp32"``); ``"tf32"`` rounds their operands to TF32's
10-bit mantissa first (the control that a lower precision must fail);
``"fp64"`` sums them in float64 and rounds each sum once (another sound
order of the same sums: a witness of how far rounding alone parts two
sound implementations).

The weights are baked layer by layer into the tensors handed in, which
the reference then owns, so it fits beside nothing else on one card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Iterator, Optional

import torch

A_MAX = 31          # 5-bit activation codes
W_MAX = 63          # 6-bit signed weight codes
ADC_MIN, ADC_MAX = -128, 127
NEG_INF = -1e30
# bytes of one chunked product's [C, rows, N] float32 readouts held at once
BLOCK_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class Dims:
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    rope_theta: float
    head_dim: Optional[int] = None
    norm_eps: float = 1e-5
    chunk_rows: int = 128

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads


@contextlib.contextmanager
def fp32_products():
    """float32 matmuls at full precision (TF32 off) inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32 (10 mantissa bits, to nearest, ties away
    from zero), held as float32."""
    i = t.to(torch.float32).contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def _div(t: torch.Tensor, d: float) -> torch.Tensor:
    """``t / d`` correctly rounded on every device (a tensor divisor)."""
    return t / torch.tensor(d, dtype=t.dtype, device=t.device)


class Linear:
    """One baked analog linear layer: ``w_eff [K_pad, N]``, per-column
    ``w_scale`` and ``gain``, chunk offsets ``[C, N]``."""

    def __init__(self, p: dict, chunk_rows: int):
        """Bake one layer's masters ``p`` (``w [K, N]``, ``w_scale``,
        ``gain``, ``fpn``).  The effective weights overwrite ``w`` where
        they fit its shape: the reference owns the tensors handed in."""
        w = p["w"]
        k, n = w.shape
        k_pad = -(-k // chunk_rows) * chunk_rows
        codes = torch.clamp(torch.round(w.to(torch.float32) / p["w_scale"]),
                            -W_MAX, W_MAX)
        fpn = p.get("fpn", {})
        if "col_gain" in fpn:
            codes = codes * fpn["col_gain"][None, :]
        if "row_gain" in fpn:
            codes = codes * fpn["row_gain"][:, None]
        if k_pad == k and w.dtype == torch.float32:
            w.copy_(codes)
            self.w_eff = w
        else:
            self.w_eff = torch.nn.functional.pad(codes, (0, 0, 0, k_pad - k))
        del codes
        self.w_scale = p["w_scale"].reshape(-1)
        self.gain = torch.broadcast_to(p["gain"].to(torch.float32),
                                       (n,)).contiguous()
        off = fpn.get("chunk_offset")
        self.offset = off if off is not None else torch.zeros(
            (k_pad // chunk_rows, n), dtype=torch.float32, device=w.device)
        self.k, self.chunk_rows = k, chunk_rows

    def readouts(self, a: torch.Tensor, precision: str) -> torch.Tensor:
        """Summed 8-bit readouts of one pass: ``a [M, K_pad]`` codes."""
        m = a.shape[0]
        k_pad, n = self.w_eff.shape
        c = k_pad // self.chunk_rows
        wide = precision == "fp64"
        w = to_tf32(self.w_eff) if precision == "tf32" else self.w_eff
        w_c = w.reshape(c, self.chunk_rows, n)
        if wide:
            w_c = w_c.to(torch.float64)
        rows = max(1, min(m, BLOCK_BYTES // ((8 if wide else 4) * c * n)))
        out = torch.empty((m, n), dtype=torch.float32, device=a.device)
        for r0 in range(0, m, rows):
            a_c = a[r0:r0 + rows].reshape(-1, c, self.chunk_rows)
            a_c = a_c.to(w_c.dtype).transpose(0, 1)
            v = torch.bmm(a_c, w_c).to(torch.float32)        # [C, rows, N]
            v.mul_(self.gain).add_(self.offset[:, None, :])
            v.round_().clamp_(ADC_MIN, ADC_MAX)
            out[r0:r0 + rows] = v.sum(dim=0)
        return out

    def __call__(self, x: torch.Tensor, precision: str = "fp32",
                 rows=None) -> torch.Tensor:
        """``x [..., K]`` in the activation dtype -> ``[..., N]`` in it.
        ``rows``: the flattened rows to compute (all by default); the
        activation LSB is taken over the whole ``x`` either way."""
        in_dtype = x.dtype
        xf = x.to(torch.float32)
        a_scale = _div(torch.clamp_min(xf.abs().max() + 1e-9, 1e-8),
                       float(A_MAX))
        flat = xf.reshape(-1, xf.shape[-1])
        lead = x.shape[:-1]
        if rows is not None:
            flat, lead = flat[rows], (len(rows),)
        pad = self.w_eff.shape[0] - self.k
        y = None
        for sign in (1.0, -1.0):
            a = torch.clamp(torch.round((sign * flat) / a_scale), 0, A_MAX)
            r = self.readouts(torch.nn.functional.pad(a, (0, pad)), precision)
            y = r if y is None else y - r
        y = y * (a_scale * self.w_scale / self.gain)
        return y.to(in_dtype).reshape(lead + (y.shape[-1],))


def _norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * scale).to(x.dtype)


def _silu(x: torch.Tensor) -> torch.Tensor:
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return x * (one / (one + torch.exp(-x)))


def _rope(x: torch.Tensor, start: int, theta: float) -> torch.Tensor:
    """Rotate-half RoPE of ``x [B, S, H, dh]`` at positions ``start..``;
    the frequencies computed on the CPU in float32."""
    b, s, _, dh = x.shape
    even = 2.0 * torch.arange(dh // 2, dtype=torch.float32)
    freqs = (1.0 / (theta ** (even / dh))).to(x.device)
    pos = start + torch.arange(s, dtype=torch.int32, device=x.device)
    angle = pos[None, :, None].to(torch.float32).expand(b, s, 1) * freqs
    cos, sin = torch.cos(angle)[:, :, None, :], torch.sin(angle)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


class ReferenceLM:
    """The reference model over a parameter tree in the benchmark's
    layout: ``embed.table``, ``layers.l0`` (every leaf stacked over the
    layers: ``ln1``, ``attn.{wq,wk,wv,wo}``, ``ln2``,
    ``mlp.{up,gate,down}``), ``final_norm``, ``lm_head``.  ``precision``:
    of the products (module docstring)."""

    MATMULS = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
               ("attn", "wo"), ("mlp", "up"), ("mlp", "gate"),
               ("mlp", "down"))

    def __init__(self, params: dict, dims: Dims, *, precision: str = "fp32"):
        self.dims, self.precision = dims, precision
        cr = dims.chunk_rows
        self.table = params["embed"]["table"]
        g = params["layers"]["l0"]
        self.ln1, self.ln2 = g["ln1"]["scale"], g["ln2"]["scale"]
        with torch.no_grad():
            self.layers = [{name: Linear(_index(g[part][name], i), cr)
                            for part, name in self.MATMULS}
                           for i in range(dims.n_layers)]
            self.lm_head = Linear(params["lm_head"], cr)
        self.final_norm = params["final_norm"]["scale"]

    def at(self, precision: str) -> "ReferenceLM":
        """The same baked model, its products at ``precision``."""
        other = object.__new__(ReferenceLM)
        other.__dict__.update(self.__dict__, precision=precision)
        return other

    def _linear(self, layer, name, x, **kw):
        return layer[name](x, precision=self.precision, **kw)

    def _operand(self, t: torch.Tensor) -> torch.Tensor:
        if self.precision == "tf32":
            return to_tf32(t)
        return t.to(torch.float64) if self.precision == "fp64" else t

    def new_cache(self, batch: int, max_len: int, device) -> list:
        """A zero float32 KV cache of ``max_len`` positions per layer."""
        d = self.dims
        shape = (batch, max_len, d.n_kv_heads, d.hd)
        return [(torch.zeros(shape, dtype=torch.float32, device=device),
                 torch.zeros(shape, dtype=torch.float32, device=device))
                for _ in self.layers]

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.table[tokens].to(torch.bfloat16)

    def _write_kv(self, h, layer, cache, start):
        d = self.dims
        b, s, _ = h.shape
        k = _rope(self._linear(layer, "wk", h).reshape(
            b, s, d.n_kv_heads, d.hd), start, d.rope_theta)
        v = self._linear(layer, "wv", h).reshape(b, s, d.n_kv_heads, d.hd)
        ck, cv = cache
        ck[:, start:start + s] = k.to(torch.float32)
        cv[:, start:start + s] = v.to(torch.float32)

    def _attention(self, h, layer, cache, start):
        d = self.dims
        b, s, _ = h.shape
        g = d.n_heads // d.n_kv_heads
        q = _rope(self._linear(layer, "wq", h).reshape(b, s, d.n_heads, d.hd),
                  start, d.rope_theta)
        self._write_kv(h, layer, cache, start)
        ck, cv = cache
        smax = ck.shape[1]
        kpos = torch.arange(smax, device=h.device)
        qpos = start + torch.arange(s, device=h.device)
        mask = (qpos[:, None] >= kpos[None, :]) & (kpos < start + s)[None, :]
        qg = q.reshape(b, s, d.n_kv_heads, g, d.hd).to(torch.float32)
        sc = _div(torch.einsum("bqhgd,bkhd->bhgqk", self._operand(qg),
                               self._operand(ck)).to(torch.float32),
                  math.sqrt(d.hd))
        sc = torch.where(mask[None, None, None], sc, NEG_INF)
        p = torch.softmax(sc, dim=-1)
        o = torch.einsum("bhgqk,bkhd->bqhgd", self._operand(p),
                         self._operand(cv)).to(torch.float32)
        return self._linear(layer, "wo",
                            o.to(h.dtype).reshape(b, s, d.n_heads * d.hd))

    def layer(self, i: int, x: torch.Tensor, cache, start: int):
        """Transformer layer ``i`` on the residual stream ``x [B, S, d]``
        at positions ``start..``, its keys and values written into
        ``cache``; returns the stream it hands on."""
        d, layer = self.dims, self.layers[i]
        h = _norm(x, self.ln1[i], d.norm_eps)
        x = x + self._attention(h, layer, cache, start)
        h = _norm(x, self.ln2[i], d.norm_eps)
        y = _silu(self._linear(layer, "gate", h)) * \
            self._linear(layer, "up", h)
        return x + self._linear(layer, "down", y)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """The logits ``[B, vocab]`` at the last position of the stream
        ``x`` that leaves the last layer (the activation LSB of the lm_head
        taken over every position)."""
        x = _norm(x, self.final_norm, self.dims.norm_eps)
        b, s, _ = x.shape
        return self.lm_head(x, precision=self.precision,
                            rows=list(range(s - 1, b * s, s)))

    def _forward(self, tokens, caches, start):
        x = self.embed(tokens)
        for i in range(len(self.layers)):
            x = self.layer(i, x, caches[i], start)
        return self.head(x)

    def steps(self, tokens: torch.Tensor, served: torch.Tensor,
              max_len: int) -> Iterator[torch.Tensor]:
        """Free-running: the logits ``[B, vocab]`` (activation dtype) of
        each served position of one group: the prefill's over the
        left-padded prompts ``tokens [B, S]``, then one decode step per
        later column of ``served [B, T]`` (fed the column before it)."""
        s = tokens.shape[1]
        with fp32_products(), torch.no_grad():
            caches = self.new_cache(tokens.shape[0], max_len, tokens.device)
            yield self._forward(tokens, caches, 0)
            for t in range(1, served.shape[1]):
                yield self._forward(served[:, t - 1:t], caches, s + t - 1)


def _index(node, i: int):
    if isinstance(node, dict):
        return {k: _index(v, i) for k, v in node.items()}
    return node[i]
