"""Cross-scoring reranker in PyTorch (port of rust_local_rag_tpu/models/reranker.py).

The whole candidate set is scored in one batched decoder forward: build
(query, chunk) prompts, tokenise them with the judge trainer's head + tail
packing at the checkpoint's train_seq_len, pad the batch to a power of two,
run the model, read the yes/no token logits at each prompt's last valid
position, and apply the reference's formula on the two logprobs

    score = e^yes / (e^yes + e^no)        (reranker.rs:519-588)

with a missing side defaulting to -10.0.

The decoder is a llama-class causal transformer (RMSNorm, RoPE, SwiGLU),
the same layer as the encoder's (models/encoder.transformer_layer) with a
causal bias, a last-valid-position readout and an f32 lm_head. Attention
goes through ops/attention.fused_attention when use_fused_attention() is
on (RAG_TPU_FUSED_ATTN=1), as in the JAX package. State_dict keys are the
safetensors names (embed, final_norm, lm_head, layers.<i>.*).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from rust_local_rag_tpu_torch.device import resolve_device
from rust_local_rag_tpu_torch.models.checkpoint import read_safetensors
from rust_local_rag_tpu_torch.models.encoder import (
    _DTYPES,
    EncoderLayer,
    _dense,
    _rmsnorm,
    _rope,
    resolve_model_file,
    transformer_layer,
)
from rust_local_rag_tpu_torch.models.tokenizer import bucket_batch, load_tokenizer
from rust_local_rag_tpu_torch.ops.attention import use_fused_attention

logger = logging.getLogger(__name__)

MISSING_LOGPROB = -10.0  # reranker.rs:567-568


@dataclass(frozen=True)
class RerankerConfig:
    vocab_size: int = 30528
    dim: int = 512
    depth: int = 8
    heads: int = 8
    ffn_dim: int = 1536
    max_len: int = 512
    rope_base: float = 10000.0
    activation_dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "RerankerConfig":
        return cls(**json.loads(s))


class Reranker(nn.Module):
    """Causal decoder: [B, L] ids + mask -> f32 logits [B, vocab] at each
    row's last valid position. Random initialisation draws from
    ``generator`` (seed 0 if None)."""

    def __init__(self, cfg: RerankerConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.embed = _dense(gen, cfg.vocab_size, cfg.dim)
        self.final_norm = nn.Parameter(torch.ones(cfg.dim))
        self.lm_head = _dense(gen, cfg.dim, cfg.vocab_size)
        self.layers = nn.ModuleList(EncoderLayer(cfg, gen) for _ in range(cfg.depth))

    def forward_last_logits(
        self, ids: torch.Tensor, mask: torch.Tensor, fused_attn: Optional[bool] = None
    ) -> torch.Tensor:
        """reranker.py:121-199 there. The plain branch's bias is -1e9 where
        a key is masked or above the diagonal; the fused kernel adds the
        two (-2e9 where both), which gives the same softmax."""
        cfg = self.cfg
        act = _DTYPES[cfg.activation_dtype]
        B, L = ids.shape
        if fused_attn is None:
            fused_attn = use_fused_attention()
        x = self.embed[ids.long()].to(act)
        cos, sin = _rope(cfg, L, ids.device)
        bias = None
        if not fused_attn:
            causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=ids.device))
            keep = causal[None, None, :, :] & mask[:, None, None, :].bool()
            bias = torch.where(
                keep,
                torch.zeros((), dtype=torch.float32, device=ids.device),
                torch.full((), -1e9, dtype=torch.float32, device=ids.device),
            )
        for layer in self.layers:
            x = transformer_layer(layer, x, cos, sin, cfg.heads, mask, bias, fused_attn, causal=True)
        x = _rmsnorm(x, self.final_norm)
        last = torch.clamp(mask.sum(dim=1) - 1, min=0).long()
        x_last = x[torch.arange(B, device=ids.device), last]
        return x_last.float() @ self.lm_head.float()


def yes_no_logprobs(
    model: Reranker,
    ids: torch.Tensor,
    mask: torch.Tensor,
    yes_id: int,
    no_id: int,
    fused_attn: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(yes logprob [B], no logprob [B]) f32 from one forward."""
    logprobs = torch.log_softmax(model.forward_last_logits(ids, mask, fused_attn), dim=-1)
    return logprobs[:, yes_id], logprobs[:, no_id]


def softmax_yes_no(yes_lp: Optional[float], no_lp: Optional[float]) -> float:
    """score = e^yes / (e^yes + e^no), missing side -> -10.0
    (reranker.rs:519-588)."""
    y = yes_lp if yes_lp is not None else MISSING_LOGPROB
    n = no_lp if no_lp is not None else MISSING_LOGPROB
    m = max(y, n)
    ye, ne = math.exp(y - m), math.exp(n - m)
    return ye / (ye + ne)


def load_reranker_checkpoint(path: str, cfg: Optional[RerankerConfig] = None):
    """-> (Reranker with the file's weights, metadata dict). The config is
    `cfg` when given, else the ``reranker_config`` metadata entry (the
    defaults when it is missing, as in the JAX package)."""
    tensors, meta = read_safetensors(path)
    cfg_json = meta.get("reranker_config")
    model = Reranker(cfg or (RerankerConfig.from_json(cfg_json) if cfg_json else RerankerConfig()))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in tensors.items()})
    return model, meta


class TransformerReranker:
    """Batched yes/no scorer on the device.

    Prompts are encoded exactly as the judge was trained: head + tail
    truncation at the checkpoint's train_seq_len (192 when the metadata
    lacks it), one fixed sequence shape. Batches pad to a power of two;
    padded rows hold one valid token (mask[:, 0] = 1) and are dropped.
    """

    def __init__(
        self,
        model: Reranker,
        tokenizer,
        judge_seq_len: int = 192,
        model_name: str = "tpu-reranker",
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = model.cfg
        self.tokenizer = tokenizer
        self.judge_seq_len = int(judge_seq_len)
        self._model_name = model_name
        self._yes_id, self._no_id = self._decision_ids("yes", "no")

    @classmethod
    def from_assets(
        cls,
        weights_path: Optional[str] = None,
        tokenizer_path: Optional[str] = None,
        model_name: str = "tpu-reranker",
        device: str | torch.device = "cuda",
        cfg: Optional[RerankerConfig] = None,
        seed: int = 1,
    ) -> "TransformerReranker":
        """The judge and tokenizer resolved by resolve_model_file (argument,
        RERANKER_WEIGHTS / TOKENIZER_PATH, committed asset). A weights file
        that does not exist gives a random init seeded with `seed` (1, as in
        the JAX package) at `cfg` (default RerankerConfig()) and
        train_seq_len 192, logged as JAX logs it (reranker.py:234-269 there)."""
        dev = resolve_device(device)
        weights_path = resolve_model_file(weights_path, "RERANKER_WEIGHTS", "reranker.safetensors")
        tokenizer_path = resolve_model_file(tokenizer_path, "TOKENIZER_PATH", "tokenizer.json")
        if os.path.exists(weights_path):
            model, meta = load_reranker_checkpoint(weights_path, cfg)
            seq_len = int(meta.get("train_seq_len", "192"))
            logger.info("Loaded reranker weights from %s", weights_path)
        else:
            model = Reranker(cfg or RerankerConfig(), torch.Generator().manual_seed(seed))
            seq_len = 192
            logger.info("Reranker running with seeded random init")
        tok = load_tokenizer(tokenizer_path, vocab_size=model.cfg.vocab_size, max_len=model.cfg.max_len)
        return cls(model, tok, seq_len, model_name, dev)

    def _decision_ids(self, a: str, b: str) -> tuple:
        """The first ids at which the two words' tokenisations differ."""
        ta = [int(t) for t in self.tokenizer.tokenize(a)]
        tb = [int(t) for t in self.tokenizer.tokenize(b)]
        for xa, xb in zip(ta, tb):
            if xa != xb:
                return xa, xb
        raise ValueError(f"tokenizer cannot distinguish {a!r} from {b!r}: {ta} vs {tb}")

    @property
    def model_name(self) -> str:
        return self._model_name

    def encode(self, prompts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """-> (ids, mask) [bucket_batch(n), judge_seq_len] int32, padded."""
        ids, mask = self.tokenizer.encode_batch_headtail(list(prompts), self.judge_seq_len)
        n = ids.shape[0]
        nb = bucket_batch(n)
        if nb > n:
            pad = np.zeros((nb - n, ids.shape[1]), dtype=ids.dtype)
            pm = np.zeros_like(pad)
            pm[:, 0] = 1
            ids = np.concatenate([ids, pad], axis=0)
            mask = np.concatenate([mask, pm], axis=0)
        return ids, mask

    def dispatch_prompts(self, prompts: Sequence[str]):
        """First half of scoring: tokenise and queue the forward on the
        device without waiting for it. -> opaque handle for fetch_prompts."""
        if not prompts:
            return (None, None, 0)
        ids, mask = self.encode(prompts)
        with torch.inference_mode():
            yes_lp, no_lp = yes_no_logprobs(
                self.model,
                torch.from_numpy(ids).to(self.device),
                torch.from_numpy(mask).to(self.device),
                self._yes_id,
                self._no_id,
            )
        return (yes_lp, no_lp, len(prompts))

    def fetch_prompts(self, handle) -> List[Tuple[float, float, float]]:
        """Second half: copy the logprobs to the host (waits for the
        device) -> [(score, yes_logprob, no_logprob)]."""
        yes_dev, no_dev, n = handle
        if n == 0:
            return []
        yes_lp = yes_dev.cpu().numpy().astype(np.float64)[:n]
        no_lp = no_dev.cpu().numpy().astype(np.float64)[:n]
        return [
            (softmax_yes_no(float(y), float(nn_)), float(y), float(nn_))
            for y, nn_ in zip(yes_lp, no_lp)
        ]

    def score_prompts(self, prompts: Sequence[str]) -> List[Tuple[float, float, float]]:
        """[(score, yes_logprob, no_logprob)], one forward for the batch."""
        return self.fetch_prompts(self.dispatch_prompts(prompts))


class FakeReranker:
    """Deterministic reranker for hermetic runs (the JAX package's
    FakeReranker): relevance from hash-encoder cosine between the prompt's
    "Query:" line and its chunk, expressed as yes/no logprobs so the whole
    scoring formula and every blend path run. numpy only, so the two
    packages give identical scores."""

    def __init__(self, dim: int = 256, model_name: str = "fake-reranker"):
        from rust_local_rag_tpu_torch.models.fake_encoder import HashEncoder

        self._enc = HashEncoder(dim=dim, model_name="fake-rerank-encoder")
        self._model_name = model_name

    @property
    def model_name(self) -> str:
        return self._model_name

    def dispatch_prompts(self, prompts: Sequence[str]):
        """Scores are complete at dispatch; the handle is the result."""
        return self.score_prompts(prompts)

    def fetch_prompts(self, handle) -> List[Tuple[float, float, float]]:
        return handle

    def score_prompts(self, prompts: Sequence[str]) -> List[Tuple[float, float, float]]:
        out: List[Tuple[float, float, float]] = []
        for p in prompts:
            lines = p.splitlines()
            query = next((ln for ln in lines if ln.lower().startswith("query:")), p)
            chunk_start = next((i for i, ln in enumerate(lines) if ln.lower().startswith("chunk")), 0)
            chunk = "\n".join(lines[chunk_start:]) or p
            sim = float(np.dot(self._enc.encode_one(query), self._enc.encode_one(chunk)))
            s = min(max(0.5 + 0.5 * sim, 1e-6), 1.0 - 1e-6)
            yes_lp = math.log(s)
            no_lp = math.log(1.0 - s)
            out.append((softmax_yes_no(yes_lp, no_lp), yes_lp, no_lp))
        return out
