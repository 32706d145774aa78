"""Model-partitioned index persistence, packed npz format (port of the
npz path of rust_local_rag_tpu/engine/persistence.py; the files are
interchangeable with the JAX package's).

  * one index file per embedding model, chunks_{model}.npz, with the model
    name sanitised for the file system;
  * atomic writes (tmp file + rename);
  * schema fields: version, model, chunks, needs_reindex, document_hashes;
  * a corrupt index is kept on disk and the engine marks needs_reindex;
  * version < 2 forces a reindex; missing document_hashes with chunks
    forces a reindex;
  * embeddings are re-normalised on load.

The JAX package's JSON v2 export and its migration from the reference's
JSON files are not part of this port yet.
"""

from __future__ import annotations

import io
import json
import logging
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from rust_local_rag_tpu_torch.engine.chunk_store import ChunkMeta

logger = logging.getLogger(__name__)

SCHEMA_VERSION = 2


def sanitize_model_name(model_name: str) -> str:
    """Filesystem-safe model name (rag_engine.rs:1435-1461)."""
    trimmed = model_name.strip()
    if not trimmed:
        return "default"
    sanitized = "".join(
        c if (c.isascii() and c.isalnum()) or c in "-_." else "_"
        for c in trimmed
    )
    if not sanitized or all(c in "_." for c in sanitized):
        return "default"
    return sanitized


def get_index_path(data_dir: str, model_name: str) -> str:
    """Native packed index path for a model (cf. rag_engine.rs:1465-1468)."""
    return os.path.join(data_dir, f"chunks_{sanitize_model_name(model_name)}.npz")


@dataclass
class IndexState:
    """Deserialized index contents."""

    model: str
    embeddings: np.ndarray  # [N, D] float32 (unit-normalized on load)
    metas: List[ChunkMeta] = field(default_factory=list)
    needs_reindex: bool = False
    document_hashes: Dict[str, str] = field(default_factory=dict)


def _normalize_rows_inplace(emb: np.ndarray) -> None:
    """Reference re-normalizes every embedding on load (rag_engine.rs:1678-1680),
    with the same ||v||^2 > 1e-20 skip rule."""
    norm_sq = np.sum(emb.astype(np.float32) ** 2, axis=1)
    ok = norm_sq > 1e-20
    emb[ok] = emb[ok] / np.sqrt(norm_sq[ok])[:, None]


def _atomic_write(path: str, data: bytes) -> None:
    """tmp + rename in the destination directory (rag_engine.rs:1503-1509)."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def save_index(data_dir: str, state: IndexState) -> str:
    """Persist to the native packed format atomically. Returns the path."""
    meta_blob = {
        "version": SCHEMA_VERSION,
        "model": state.model,
        "needs_reindex": state.needs_reindex,
        "document_hashes": state.document_hashes,
        "chunks": [
            {
                "id": m.id,
                "document_name": m.document_name,
                "text": m.text,
                "chunk_index": m.chunk_index,
                "page_number": m.page_number,
                "section": m.section,
                "metadata": m.metadata,
            }
            for m in state.metas
        ],
    }
    buf = io.BytesIO()
    np.savez_compressed(
        buf,
        embeddings=np.asarray(state.embeddings, dtype=np.float32),
        meta_json=np.frombuffer(
            json.dumps(meta_blob, ensure_ascii=False).encode("utf-8"), dtype=np.uint8
        ),
    )
    path = get_index_path(data_dir, state.model)
    _atomic_write(path, buf.getvalue())
    logger.debug(
        "Saved %d chunks to %s for model '%s'", len(state.metas), path, state.model
    )
    return path


class LoadResult:
    """Outcome of load_index: state or a needs_reindex signal."""

    def __init__(self, state: Optional[IndexState], needs_reindex: bool):
        self.state = state
        self.needs_reindex = needs_reindex


def load_index(data_dir: str, model_name: str) -> LoadResult:
    """The npz index for this model, a needs_reindex signal when it is
    corrupt or outdated, or a fresh start when there is none."""
    npz_path = get_index_path(data_dir, model_name)
    if not os.path.exists(npz_path):
        logger.info("No existing index for model '%s'. Starting fresh.", model_name)
        return LoadResult(None, False)
    try:
        return LoadResult(_load_npz(npz_path, model_name), False)
    except Exception as e:  # noqa: BLE001 - corrupt: keep the file, reindex
        logger.warning(
            "Failed to parse index at %s: %s. Starting fresh for model "
            "'%s' and marking for reindex.",
            npz_path,
            e,
            model_name,
        )
        return LoadResult(None, True)


class _VersionTooOld(Exception):
    pass


def _load_npz(path: str, expect_model: str) -> IndexState:
    with np.load(path, allow_pickle=False) as z:
        emb = np.asarray(z["embeddings"], dtype=np.float32)
        meta = json.loads(bytes(z["meta_json"].tobytes()).decode("utf-8"))
    if int(meta.get("version", 0)) < SCHEMA_VERSION:
        raise _VersionTooOld(str(meta.get("version")))
    metas = [
        ChunkMeta(
            id=c["id"],
            document_name=c["document_name"],
            text=c["text"],
            chunk_index=int(c["chunk_index"]),
            page_number=int(c.get("page_number", 0)),
            section=c.get("section"),
            metadata=c.get("metadata") or {},
        )
        for c in meta["chunks"]
    ]
    if emb.shape[0] != len(metas):
        raise ValueError(
            f"embedding rows {emb.shape[0]} != chunk records {len(metas)}"
        )
    _normalize_rows_inplace(emb)
    state = IndexState(
        model=meta["model"],
        embeddings=emb,
        metas=metas,
        needs_reindex=bool(meta.get("needs_reindex", False)),
        document_hashes=dict(meta.get("document_hashes") or {}),
    )
    _post_load_checks(state)
    return state


def _post_load_checks(state: IndexState) -> None:
    """Missing fingerprints with chunks present -> reindex
    (rag_engine.rs:1686-1691)."""
    if not state.document_hashes and state.metas:
        logger.info(
            "No document fingerprints found; marking for reindex to "
            "initialize change detection."
        )
        state.needs_reindex = True
