"""Text embedding encoder in PyTorch (port of rust_local_rag_tpu/models/encoder.py).

Architecture, as in the JAX package:
  * pre-RMSNorm transformer encoder
  * rotary position embeddings
  * SwiGLU feed-forward
  * masked mean pooling, optional out_proj to out_dim, L2 normalisation
  * f32 parameters, bf16 activations and matmuls with f32 accumulation

Attention is written in plain torch ops, as the JAX package's default path
writes it (encoder.py:180-189 there): no scaled_dot_product_attention. The
dtype flow follows the JAX code line by line: RoPE promotes q and k to f32,
the score matmul runs in f32, probabilities are cast to bf16 before PV.
With fused_attn (default: use_fused_attention(), RAG_TPU_FUSED_ATTN=1) the
rotated q and k are cast to the activation type and attention goes through
ops/attention.fused_attention, as encoder.py:174-178 there does.
transformer_layer is shared with the reranker (models/reranker.py).
State_dict keys are the safetensors names (embed, final_norm, out_proj,
layers.<i>.{attn_norm,wq,wk,wv,wo,ffn_norm,w_gate,w_up,w_down}).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from rust_local_rag_tpu_torch.device import resolve_device
from rust_local_rag_tpu_torch.models.checkpoint import read_safetensors
from rust_local_rag_tpu_torch.models.tokenizer import bucket_batch, load_tokenizer
from rust_local_rag_tpu_torch.ops.attention import fused_attention, use_fused_attention
from rust_local_rag_tpu_torch.utils import profiling

logger = logging.getLogger(__name__)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


@dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 30528
    dim: int = 768
    depth: int = 12
    heads: int = 12
    ffn_dim: int = 2048  # SwiGLU inner width
    max_len: int = 512
    rope_base: float = 10000.0
    activation_dtype: str = "bfloat16"
    out_dim: int = 768

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "EncoderConfig":
        return cls(**json.loads(s))


def default_asset(name: str) -> str:
    """Path of a model asset committed with the JAX package
    (rust_local_rag_tpu/assets/<name>); the port reads the same files."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, "rust_local_rag_tpu", "assets", name)


def resolve_model_file(explicit: Optional[str], env_key: str, asset: str) -> str:
    """The file a model loads, in the JAX package's order
    (encoder.py:249-258, reranker.py:234-238 there): the explicit argument,
    then the environment variable `env_key` (ENCODER_WEIGHTS,
    RERANKER_WEIGHTS or TOKENIZER_PATH), then the committed asset."""
    return explicit or os.environ.get(env_key) or default_asset(asset)


def _rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * weight).to(x.dtype)


def _rope(cfg: EncoderConfig, seq_len: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    half = cfg.head_dim // 2
    base = torch.tensor(cfg.rope_base, dtype=torch.float32, device=device)
    freqs = base ** (-torch.arange(0, half, dtype=torch.float32, device=device) / half)
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    angles = torch.outer(t, freqs)  # [L, half]
    return torch.cos(angles), torch.sin(angles)


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [B, H, L, Dh]; rotates the (first half, second half) pairs. A
    bf16 x times the f32 tables promotes to f32, as in jnp."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    c = cos[None, None, :, :]
    s = sin[None, None, :, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def _dense(gen: torch.Generator, *shape: int) -> nn.Parameter:
    return nn.Parameter(torch.randn(*shape, generator=gen, dtype=torch.float32) * 0.02)


class EncoderLayer(nn.Module):
    """Weights of one pre-norm transformer layer (encoder and reranker)."""

    def __init__(self, cfg, gen: torch.Generator):
        super().__init__()
        d, f = cfg.dim, cfg.ffn_dim
        self.attn_norm = nn.Parameter(torch.ones(d))
        self.wq = _dense(gen, d, d)
        self.wk = _dense(gen, d, d)
        self.wv = _dense(gen, d, d)
        self.wo = _dense(gen, d, d)
        self.ffn_norm = nn.Parameter(torch.ones(d))
        self.w_gate = _dense(gen, d, f)
        self.w_up = _dense(gen, d, f)
        self.w_down = _dense(gen, f, d)


def transformer_layer(
    layer: EncoderLayer,
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    heads: int,
    mask: torch.Tensor,
    attn_bias: Optional[torch.Tensor],
    fused_attn: bool,
    causal: bool,
) -> torch.Tensor:
    """x [B, L, D] (activation type) -> x after attention and SwiGLU, with
    residuals. The plain branch adds attn_bias ([B, 1, L, L] or broadcastable,
    f32) to the f32 scores; the fused branch gives the kernel the mask and
    the causal flag."""
    act = x.dtype
    B, L, D = x.shape
    Dh = D // heads
    h = _rmsnorm(x, layer.attn_norm)
    q = (h @ layer.wq.to(act)).view(B, L, heads, Dh).transpose(1, 2)
    k = (h @ layer.wk.to(act)).view(B, L, heads, Dh).transpose(1, 2)
    v = (h @ layer.wv.to(act)).view(B, L, heads, Dh).transpose(1, 2)
    q = _apply_rope(q, cos, sin)
    k = _apply_rope(k, cos, sin)
    if fused_attn:
        ctx = fused_attention(q.to(act), k.to(act), v, mask.to(torch.int32).contiguous(), causal=causal)
    else:
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(Dh) + attn_bias
        probs = torch.softmax(scores, dim=-1).to(act)
        ctx = torch.matmul(probs, v)
    ctx = ctx.transpose(1, 2).reshape(B, L, D)
    x = x + ctx @ layer.wo.to(act)

    h = _rmsnorm(x, layer.ffn_norm)
    gate = h @ layer.w_gate.to(act)
    up = h @ layer.w_up.to(act)
    return x + (nn.functional.silu(gate) * up) @ layer.w_down.to(act)


class Encoder(nn.Module):
    """[B, L] ids + mask -> [B, out_dim] L2-normalised f32 embeddings.
    Random initialisation draws from ``generator`` (seed 0 if None)."""

    def __init__(self, cfg: EncoderConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.embed = _dense(gen, cfg.vocab_size, cfg.dim)
        self.final_norm = nn.Parameter(torch.ones(cfg.dim))
        self.layers = nn.ModuleList(EncoderLayer(cfg, gen) for _ in range(cfg.depth))
        if cfg.out_dim != cfg.dim:
            self.out_proj = _dense(gen, cfg.dim, cfg.out_dim)

    def forward(
        self, ids: torch.Tensor, mask: torch.Tensor, fused_attn: Optional[bool] = None
    ) -> torch.Tensor:
        cfg = self.cfg
        act = _DTYPES[cfg.activation_dtype]
        L = ids.shape[1]
        if fused_attn is None:
            fused_attn = use_fused_attention()
        x = self.embed[ids.long()].to(act)  # [B, L, D]
        cos, sin = _rope(cfg, L, ids.device)
        attn_bias = None
        if not fused_attn:
            attn_bias = torch.where(
                mask[:, None, None, :].bool(),
                torch.zeros((), dtype=torch.float32, device=ids.device),
                torch.full((), -1e9, dtype=torch.float32, device=ids.device),
            )
        for layer in self.layers:
            x = transformer_layer(layer, x, cos, sin, cfg.heads, mask, attn_bias, fused_attn, causal=False)

        x = _rmsnorm(x, self.final_norm).float()
        m = mask.float()[:, :, None]
        pooled = torch.sum(x * m, dim=1) / torch.clamp(torch.sum(m, dim=1), min=1.0)
        if cfg.out_dim != cfg.dim:
            pooled = pooled @ self.out_proj
        norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
        return pooled / torch.clamp(norm, min=1e-10)


def load_encoder_checkpoint_full(path: str):
    """-> (state_dict of f32 tensors, EncoderConfig or None, metadata dict),
    as the JAX package's load_encoder_checkpoint_full (None for a file
    without an ``encoder_config`` entry)."""
    tensors, meta = read_safetensors(path)
    cfg_json = meta.get("encoder_config")
    cfg = EncoderConfig.from_json(cfg_json) if cfg_json else None
    return {k: torch.from_numpy(v) for k, v in tensors.items()}, cfg, meta


def load_encoder_checkpoint(path: str):
    """-> (Encoder with the file's weights, metadata dict). The config
    comes from the ``encoder_config`` metadata entry."""
    state, cfg, meta = load_encoder_checkpoint_full(path)
    if cfg is None:
        raise ValueError(f"{path}: no encoder_config in the safetensors metadata")
    enc = Encoder(cfg)
    enc.load_state_dict(state)
    return enc, meta


class TransformerEncoderModel:
    """Tokenise on the host, embed on the device.

    Query and document prefixes come from the checkpoint metadata (empty
    for a randomly initialised encoder). Batches pad to a power of two and
    sequences to a length bucket, as in the JAX package; padded rows are
    dropped.
    """

    def __init__(
        self,
        encoder: Encoder,
        tokenizer,
        model_name: str = "nomic-embed-text",
        query_prefix: str = "",
        document_prefix: str = "",
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.encoder = encoder.to(self.device).eval()
        self.cfg = encoder.cfg
        self.tokenizer = tokenizer
        self._model_name = model_name
        self._query_prefix = query_prefix
        self._doc_prefix = document_prefix

    @classmethod
    def from_assets(
        cls,
        weights_path: Optional[str] = None,
        tokenizer_path: Optional[str] = None,
        model_name: str = "nomic-embed-text",
        device: str | torch.device = "cuda",
        cfg: Optional[EncoderConfig] = None,
        seed: int = 0,
    ) -> "TransformerEncoderModel":
        """The encoder and tokenizer resolved by resolve_model_file
        (argument, ENCODER_WEIGHTS / TOKENIZER_PATH, committed asset). A
        weights file that does not exist gives a random init seeded with
        `seed` (0, as in the JAX package) at `cfg` (default EncoderConfig()),
        logged as JAX logs it; an explicit `cfg` wins over the checkpoint's,
        whose missing config means the defaults (encoder.py:266-283 there)."""
        dev = resolve_device(device)
        weights_path = resolve_model_file(weights_path, "ENCODER_WEIGHTS", "encoder.safetensors")
        tokenizer_path = resolve_model_file(tokenizer_path, "TOKENIZER_PATH", "tokenizer.json")
        meta: dict = {}
        if os.path.exists(weights_path):
            state, meta_cfg, meta = load_encoder_checkpoint_full(weights_path)
            enc = Encoder(cfg or meta_cfg or EncoderConfig())
            enc.load_state_dict(state)
            logger.info("Loaded encoder weights from %s", weights_path)
        else:
            enc = Encoder(cfg or EncoderConfig(), torch.Generator().manual_seed(seed))
            logger.info("Encoder running with seeded random init (no weights file)")
        tok = load_tokenizer(tokenizer_path, vocab_size=enc.cfg.vocab_size, max_len=enc.cfg.max_len)
        return cls(
            enc, tok, model_name,
            query_prefix=meta.get("query_prefix", ""),
            document_prefix=meta.get("document_prefix", ""),
            device=dev,
        )

    @property
    def dim(self) -> int:
        return self.cfg.out_dim

    @property
    def model_name(self) -> str:
        return self._model_name

    def _forward_padded(self, texts: Sequence[str]) -> torch.Tensor:
        """-> [bucket_batch(n), out_dim] f32 on the device (the forward
        enqueued, not waited for)."""
        n = len(texts)
        with profiling.span("encoder.tokenize", n):
            ids, mask = self.tokenizer.encode_batch(texts)
            nb = bucket_batch(n)
            if nb > n:
                pad = np.zeros((nb - n, ids.shape[1]), dtype=ids.dtype)
                ids = np.concatenate([ids, pad], axis=0)
                mask = np.concatenate([mask, np.zeros_like(pad)], axis=0)
                mask[n:, 0] = 1  # one valid token so pooling stays finite
        if profiling.TRACER.on:
            profiling.count("encoder.tokens_valid", int(mask[:n].sum()))
            profiling.count("encoder.tokens_computed", int(mask.size))
        with profiling.span("encoder.forward", n), torch.inference_mode():
            return self.encoder(
                torch.from_numpy(ids).to(self.device),
                torch.from_numpy(mask).to(self.device),
            )

    def encode(self, texts: Sequence[str], _prefix: Optional[str] = None) -> np.ndarray:
        """[n] texts -> [n, out_dim] f32 unit-normalised embeddings
        (document prefix unless another is given)."""
        if not texts:
            return np.zeros((0, self.cfg.out_dim), dtype=np.float32)
        prefix = self._doc_prefix if _prefix is None else _prefix
        texts = [prefix + t for t in texts] if prefix else list(texts)
        out = self._forward_padded(texts)[: len(texts)]
        with profiling.span("encoder.readback", len(texts)):
            return out.cpu().numpy()

    def encode_queries(self, texts: Sequence[str]) -> np.ndarray:
        return self.encode(texts, _prefix=self._query_prefix)

    def encode_queries_device(self, texts: Sequence[str]) -> torch.Tensor:
        """Query embeddings kept on the device: [bucket_batch(n), out_dim];
        padded rows are unit vectors the caller drops."""
        texts = [self._query_prefix + t for t in texts] if self._query_prefix else list(texts)
        return self._forward_padded(texts)
