"""The reference forward passes of the system's two committed models, in
plain PyTorch at the precision their configurations state: f32 parameters
cast to the activation type (bfloat16) at each matmul with f32
accumulation, RMSNorm and RoPE in f32, the attention scores in f32
(TF32 off) and the probabilities cast to bf16 before PV.

  * the encoder: pre-RMSNorm transformer, RoPE, SwiGLU, masked mean
    pooling, an f32 output projection, L2 normalisation;
  * the judge: the same layer with a causal mask, the last valid
    position's hidden state through an f32 lm_head, log-softmax, read at
    the "yes" and "no" ids; score = e^yes / (e^yes + e^no).

`fp8=True` is the control: every linear layer's operands (weights per
tensor, activations per row) are rounded to float8 e4m3 with a scale that
maps their largest magnitude to 448, the step below the stated bfloat16.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from reference import weights

ACT = torch.bfloat16
FP8_MAX = 448.0


def full_precision() -> None:
    """No TF32 in the reference's f32 matmuls; bf16 products sum in f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


@dataclass
class Model:
    params: Dict[str, torch.Tensor]
    cfg: dict
    meta: Dict[str, str]

    @property
    def depth(self) -> int:
        return int(self.cfg["depth"])


def metadata(path: str) -> Dict[str, str]:
    return weights.metadata(path)


def load_config(path: str, config_key: str) -> dict:
    """A model's configuration from its file's metadata."""
    return json.loads(weights.metadata(path)[config_key])


def load(path: str, config_key: str, device) -> Model:
    """The safetensors file at `path` with its config from the metadata
    entry `config_key` ("encoder_config" or "reranker_config")."""
    params, meta = weights.read(path)
    cfg = json.loads(meta[config_key])
    return Model({k: v.to(device) for k, v in params.items()}, cfg, meta)


def _fp8(x: torch.Tensor, dim=None) -> torch.Tensor:
    """x rounded to e4m3 under a scale (per tensor, or per slice along
    `dim`) that maps its largest magnitude to FP8_MAX, back in x's type."""
    x32 = x.float()
    amax = x32.abs().amax() if dim is None else x32.abs().amax(dim=dim, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / FP8_MAX
    return ((x32 / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)


def _linear(h: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    w = w.to(h.dtype)
    if fp8:
        h, w = _fp8(h, dim=-1), _fp8(w)
    return h @ w


def _rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * weight).to(x.dtype)


def _rope(head_dim: int, base: float, seq_len: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    half = head_dim // 2
    b = torch.tensor(base, dtype=torch.float32, device=device)
    freqs = b ** (-torch.arange(0, half, dtype=torch.float32, device=device) / half)
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    angles = torch.outer(t, freqs)
    return torch.cos(angles), torch.sin(angles)


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, H, L, Dh] bf16 times f32 tables: the result is f32."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    c, s = cos[None, None], sin[None, None]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def _layer(p: Dict[str, torch.Tensor], i: int, x: torch.Tensor, cos, sin, heads: int, bias: torch.Tensor,
           fp8: bool) -> torch.Tensor:
    w = lambda name: p[f"layers.{i}.{name}"]  # noqa: E731
    B, L, D = x.shape
    dh = D // heads
    h = _rmsnorm(x, w("attn_norm"))
    split = lambda t: t.view(B, L, heads, dh).transpose(1, 2)  # noqa: E731
    q = _apply_rope(split(_linear(h, w("wq"), fp8)), cos, sin)
    k = _apply_rope(split(_linear(h, w("wk"), fp8)), cos, sin)
    v = split(_linear(h, w("wv"), fp8))
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh) + bias
    ctx = torch.matmul(torch.softmax(scores, dim=-1).to(x.dtype), v)
    x = x + _linear(ctx.transpose(1, 2).reshape(B, L, D), w("wo"), fp8)
    h = _rmsnorm(x, w("ffn_norm"))
    gate = _linear(h, w("w_gate"), fp8)
    up = _linear(h, w("w_up"), fp8)
    return x + _linear(torch.nn.functional.silu(gate) * up, w("w_down"), fp8)


def _trunk(m: Model, ids: torch.Tensor, mask: torch.Tensor, causal: bool, fp8: bool) -> torch.Tensor:
    cfg = m.cfg
    B, L = ids.shape
    x = m.params["embed"][ids.long()].to(ACT)
    cos, sin = _rope(cfg["dim"] // cfg["heads"], cfg["rope_base"], L, ids.device)
    keep = mask[:, None, None, :].bool()
    if causal:
        keep = keep & torch.tril(torch.ones((L, L), dtype=torch.bool, device=ids.device))[None, None]
    bias = torch.where(keep, torch.zeros((), device=ids.device), torch.full((), -1e9, device=ids.device))
    for i in range(m.depth):
        x = _layer(m.params, i, x, cos, sin, cfg["heads"], bias, fp8)
    return _rmsnorm(x, m.params["final_norm"])


@torch.inference_mode()
def encode(m: Model, ids: torch.Tensor, mask: torch.Tensor, fp8: bool = False) -> torch.Tensor:
    """[B, L] ids and mask -> [B, out_dim] f32 unit embeddings."""
    x = _trunk(m, ids, mask, False, fp8).float()
    w = mask.float()[:, :, None]
    pooled = torch.sum(x * w, dim=1) / torch.clamp(torch.sum(w, dim=1), min=1.0)
    if "out_proj" in m.params:
        pooled = pooled @ m.params["out_proj"]
    return pooled / torch.clamp(torch.linalg.vector_norm(pooled, dim=-1, keepdim=True), min=1e-10)


@torch.inference_mode()
def judge(m: Model, ids: torch.Tensor, mask: torch.Tensor, yes_id: int, no_id: int,
          fp8: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, L] ids and mask -> (yes logprob [B], no logprob [B]) f32."""
    x = _trunk(m, ids, mask, True, fp8)
    last = torch.clamp(mask.sum(dim=1) - 1, min=0).long()
    logits = x[torch.arange(ids.shape[0], device=ids.device), last].float() @ m.params["lm_head"].float()
    lp = torch.log_softmax(logits, dim=-1)
    return lp[:, yes_id], lp[:, no_id]


def yes_probability(yes: float, no: float) -> float:
    m = max(yes, no)
    a, b = math.exp(yes - m), math.exp(no - m)
    return a / (a + b)
