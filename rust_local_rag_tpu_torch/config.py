"""Scoring weights, model names, directories and service knobs read from
the environment.

Copy of rust_local_rag_tpu/config.py under the same environment variable
names: four scoring weights validated to be finite and in [0, 1] and
cached after first read, MAX_TOP_K, the embedding batch size, cooldown and
timeout, the model names, the data / documents / log directories, the log
level and size cap, the MCP bind address and endpoint, and the prompts
directory.
"""

from __future__ import annotations

import os
from typing import Optional

DEFAULT_EMBEDDING_WEIGHT = 0.7
DEFAULT_LEXICAL_WEIGHT = 0.3
DEFAULT_RERANKER_WEIGHT = 0.7
DEFAULT_INITIAL_SCORE_WEIGHT = 0.3

MAX_TOP_K = 100

_weight_cache: dict[str, float] = {}


def _valid_weight(value) -> Optional[float]:
    try:
        w = float(value)
    except (TypeError, ValueError):
        return None
    if w != w or w in (float("inf"), float("-inf")) or not (0.0 <= w <= 1.0):
        return None
    return w


def _cached_weight(env_var: str, default: float) -> float:
    if env_var not in _weight_cache:
        raw = os.environ.get(env_var)
        w = None if raw is None else _valid_weight(raw)
        _weight_cache[env_var] = default if w is None else w
    return _weight_cache[env_var]


def reset_weight_cache() -> None:
    """Forget the cached weights (tests change the environment)."""
    _weight_cache.clear()


def get_embedding_weight() -> float:
    return _cached_weight("RAG_EMBEDDING_WEIGHT", DEFAULT_EMBEDDING_WEIGHT)


def get_lexical_weight() -> float:
    return _cached_weight("RAG_LEXICAL_WEIGHT", DEFAULT_LEXICAL_WEIGHT)


def get_reranker_weight() -> float:
    return _cached_weight("RAG_RERANKER_WEIGHT", DEFAULT_RERANKER_WEIGHT)


def get_initial_score_weight() -> float:
    return _cached_weight("RAG_INITIAL_SCORE_WEIGHT", DEFAULT_INITIAL_SCORE_WEIGHT)


def resolve_weight(override: Optional[float], default: float) -> float:
    """The override when finite and in [0, 1], else the default."""
    if override is None:
        return default
    w = _valid_weight(override)
    return default if w is None else w


class QueryWeights:
    """Optional per-query weight overrides; invalid values fall back to
    the cached environment defaults."""

    __slots__ = ("embedding", "lexical", "reranker", "initial")

    def __init__(
        self,
        embedding: Optional[float] = None,
        lexical: Optional[float] = None,
        reranker: Optional[float] = None,
        initial: Optional[float] = None,
    ):
        self.embedding = embedding
        self.lexical = lexical
        self.reranker = reranker
        self.initial = initial

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "QueryWeights":
        if not d:
            return cls()
        return cls(
            embedding=d.get("embedding"),
            lexical=d.get("lexical"),
            reranker=d.get("reranker"),
            initial=d.get("initial"),
        )


class ResolvedWeights:
    """Effective weights after override validation."""

    __slots__ = ("embedding", "lexical", "reranker", "initial")

    def __init__(self, embedding: float, lexical: float, reranker: float, initial: float):
        self.embedding = embedding
        self.lexical = lexical
        self.reranker = reranker
        self.initial = initial

    @classmethod
    def from_query_weights(cls, weights: Optional[QueryWeights]) -> "ResolvedWeights":
        w = weights
        return cls(
            embedding=resolve_weight(w.embedding if w else None, get_embedding_weight()),
            lexical=resolve_weight(w.lexical if w else None, get_lexical_weight()),
            reranker=resolve_weight(w.reranker if w else None, get_reranker_weight()),
            initial=resolve_weight(w.initial if w else None, get_initial_score_weight()),
        )


def _env_number(env_var: str, default, cast):
    try:
        return cast(os.environ.get(env_var) or default)
    except ValueError:
        return default


def env_float(env_var: str, default: float) -> float:
    """A float setting; unset, empty or malformed -> default."""
    return _env_number(env_var, default, float)


def get_batch_size() -> int:
    """Ingest embedding batch size (EMBEDDING_BATCH_SIZE)."""
    return _env_number("EMBEDDING_BATCH_SIZE", 128, int)


def get_batch_timeout_s() -> float:
    """Per-batch embedding timeout during ingest; 0 disables."""
    return env_float("EMBEDDING_BATCH_TIMEOUT_S", 1200.0)


def get_batch_cooldown_ms() -> int:
    """Pause between embedding batches (EMBEDDING_BATCH_COOLDOWN_MS)."""
    return _env_number("EMBEDDING_BATCH_COOLDOWN_MS", 0, int)


def get_data_dir() -> str:
    return os.environ.get("DATA_DIR", "./data")


def get_documents_dir() -> str:
    return os.environ.get("DOCUMENTS_DIR", "./documents")


def get_log_dir() -> str:
    """LOG_DIR, else /var/log/rust-local-rag-tpu where /var/log is
    writable, else ./logs."""
    env = os.environ.get("LOG_DIR")
    if env:
        return env
    if os.path.isdir("/var/log") and os.access("/var/log", os.W_OK):
        return "/var/log/rust-local-rag-tpu"
    return "./logs"


def get_log_level() -> str:
    return os.environ.get("LOG_LEVEL", "info")


def get_log_max_mb() -> int:
    try:
        return int(os.environ.get("LOG_MAX_MB", "5"))
    except ValueError:
        return 5


def get_embedding_model() -> str:
    """Embedding model name (RAG_TPU_EMBEDDING_MODEL, else the reference's
    OLLAMA_EMBEDDING_MODEL); also the name of the index files on disk."""
    return (
        os.environ.get("RAG_TPU_EMBEDDING_MODEL")
        or os.environ.get("OLLAMA_EMBEDDING_MODEL")
        or "nomic-embed-text"
    )


def get_mcp_http_bind() -> str:
    return os.environ.get("MCP_HTTP_BIND", "127.0.0.1:3046")


def get_mcp_http_endpoint() -> str:
    return os.environ.get("MCP_HTTP_ENDPOINT", "/mcp")


def get_rerank_model() -> Optional[str]:
    """Rerank model name (RAG_TPU_RERANK_MODEL, else the reference's
    OLLAMA_RERANK_MODEL); None disables the second stage."""
    return os.environ.get("RAG_TPU_RERANK_MODEL") or os.environ.get("OLLAMA_RERANK_MODEL")


def get_prompts_dir() -> str:
    """Directory of prompt templates (PROMPTS_DIR), relative to the
    working directory by default."""
    return os.environ.get("PROMPTS_DIR", "./prompts")
