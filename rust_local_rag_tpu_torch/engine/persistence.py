"""Model-partitioned index persistence (port of
rust_local_rag_tpu/engine/persistence.py; the files are interchangeable
with the JAX package's).

  * one index file per embedding model, chunks_{model}.npz, with the model
    name sanitised for the file system;
  * atomic writes (tmp file + rename);
  * schema fields: version, model, chunks, needs_reindex, document_hashes;
  * a corrupt index is kept on disk and the engine marks needs_reindex;
  * version < 2 forces a reindex; missing document_hashes with chunks
    forces a reindex;
  * embeddings are re-normalised on load.

The native format is packed npz (one [N, D] f32 embedding matrix + one JSON
metadata blob), the embeddings stored and the metadata deflated; files
deflated throughout load as well. The reference's JSON v2 format
(chunks_{model}.json) is still read and migrated to npz, and a legacy
chunks.json is migrated when its model matches; neither is ever deleted.
export_reference_json writes the JSON v2 format.
"""

from __future__ import annotations

import io
import json
import logging
import os
import tempfile
import zipfile
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


def get_reference_json_path(data_dir: str, model_name: str) -> str:
    """The reference's model-specific JSON path (for migration)."""
    return os.path.join(data_dir, f"chunks_{sanitize_model_name(model_name)}.json")


def get_legacy_path(data_dir: str) -> str:
    """The reference's pre-partitioning path (rag_engine.rs:1471-1473)."""
    return os.path.join(data_dir, "chunks.json")


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


def _atomic_write(path: str, write) -> None:
    """tmp + rename in the destination directory (rag_engine.rs:1503-1509):
    write(f) fills the temporary file, which replaces path only when whole."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _meta_json(state: IndexState) -> bytes:
    """The npz's metadata blob: the schema fields and every chunk record."""
    blob = {
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
    return json.dumps(blob, ensure_ascii=False).encode("utf-8")


def _write_npz(f, emb: np.ndarray, meta: bytes) -> None:
    """np.savez's layout, one .npy member each, with the f32 embeddings
    stored and the metadata JSON deflated at level 1."""
    with zipfile.ZipFile(f, "w", zipfile.ZIP_STORED, allowZip64=True) as z:
        with z.open("embeddings.npy", "w", force_zip64=True) as m:
            np.lib.format.write_array(m, emb, allow_pickle=False)
        buf = io.BytesIO()
        np.lib.format.write_array(buf, np.frombuffer(meta, dtype=np.uint8), allow_pickle=False)
        z.writestr("meta_json.npy", buf.getvalue(), compress_type=zipfile.ZIP_DEFLATED, compresslevel=1)


def save_index(data_dir: str, state: IndexState) -> str:
    """Persist to the native packed format atomically. Returns the path.

    The npz is written straight into the temporary file, its embeddings
    stored: deflating f32 noise took 5.5 of the 5.9 s a save of a
    33,033-chunk index took on an H100 machine's host (PERF.md), past the
    shutdown flush's 5 s budget, and saved little. The metadata JSON,
    which deflates well, is deflated at level 1. np.load reads stored and
    deflated members alike, so the JAX package loads these files and the
    port still loads files deflated throughout, the JAX package's too."""
    emb = np.asarray(state.embeddings, dtype=np.float32)
    meta = _meta_json(state)
    path = get_index_path(data_dir, state.model)
    _atomic_write(path, lambda f: _write_npz(f, emb, meta))
    logger.debug(
        "Saved %d chunks to %s for model '%s'", len(state.metas), path, state.model
    )
    return path


def export_reference_json(data_dir: str, state: IndexState) -> str:
    """Write a reference-compatible v2 JSON index (round-trip support)."""
    chunks = {}
    for i, m in enumerate(state.metas):
        chunks[m.id] = {
            "id": m.id,
            "document_name": m.document_name,
            "text": m.text,
            "embedding": [float(x) for x in state.embeddings[i]],
            "chunk_index": m.chunk_index,
            "page_number": m.page_number,
            "section": m.section,
            "metadata": _meta_to_reference(m.metadata),
        }
    blob = {
        "version": SCHEMA_VERSION,
        "model": state.model,
        "chunks": chunks,
        "needs_reindex": state.needs_reindex,
        "document_hashes": state.document_hashes,
    }
    path = get_reference_json_path(data_dir, state.model)
    data = json.dumps(blob, indent=2).encode("utf-8")
    _atomic_write(path, lambda f: f.write(data))
    return path


def _meta_to_reference(md: dict) -> dict:
    """ChunkMetadata shape (rag_engine.rs:35-42)."""
    return {
        "page_range": md.get("page_range"),
        "sentence_range": md.get("sentence_range"),
        "section_title": md.get("section_title"),
        "token_count": md.get("token_count", 0),
        "overlap_with_previous": md.get("overlap_with_previous", 0),
    }


class LoadResult:
    """Outcome of load_index: state or a needs_reindex signal."""

    def __init__(
        self,
        state: Optional[IndexState],
        needs_reindex: bool,
        migrated: bool = False,
    ):
        self.state = state
        self.needs_reindex = needs_reindex
        self.migrated = migrated


def load_index(data_dir: str, model_name: str) -> LoadResult:
    """Load strategy (rag_engine.rs:1543-1651):
    1. native npz for this model;
    2. the reference's model-specific JSON (migrate to npz);
    3. legacy chunks.json only when its model matches (migrate);
    4. otherwise start fresh. Never delete another model's data.
    """
    npz_path = get_index_path(data_dir, model_name)
    if os.path.exists(npz_path):
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

    json_path = get_reference_json_path(data_dir, model_name)
    if os.path.exists(json_path):
        logger.info("Migrating reference JSON index %s to packed format", json_path)
        try:
            state = _load_reference_json(json_path, expect_model=model_name)
        except _VersionTooOld:
            return LoadResult(None, True)
        except Exception as e:  # noqa: BLE001
            logger.warning(
                "Failed to parse reference index %s: %s. Marking for reindex.",
                json_path,
                e,
            )
            return LoadResult(None, True)
        if state is not None:
            save_index(data_dir, state)  # migrate; JSON preserved for safety
            return LoadResult(state, state.needs_reindex, migrated=True)

    legacy = get_legacy_path(data_dir)
    if os.path.exists(legacy):
        try:
            with open(legacy, "r", encoding="utf-8") as f:
                raw = json.load(f)
        except Exception as e:  # noqa: BLE001
            logger.warning("Legacy index unreadable: %s", e)
            return LoadResult(None, False)
        model = raw.get("model") if isinstance(raw, dict) else None
        if model == model_name:
            logger.info(
                "Legacy index matches current model '%s'. Migrating.", model_name
            )
            try:
                state = _parse_reference_blob(raw, expect_model=model_name)
            except _VersionTooOld:
                return LoadResult(None, True)
            except Exception as e:  # noqa: BLE001
                logger.warning("Failed to parse legacy index: %s", e)
                return LoadResult(None, False)
            if state is not None:
                save_index(data_dir, state)
                return LoadResult(state, state.needs_reindex, migrated=True)
        elif model is not None:
            logger.info(
                "Legacy index belongs to model '%s', not '%s'. Preserved.",
                model,
                model_name,
            )
        else:
            # very old raw-chunks format: reindex required
            if isinstance(raw, dict) and raw:
                logger.warning(
                    "Found legacy chunks without model info; reindex required."
                )
                return LoadResult(None, True)

    logger.info("No existing index for model '%s'. Starting fresh.", model_name)
    return LoadResult(None, False)


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


def _load_reference_json(path: str, expect_model: str) -> Optional[IndexState]:
    with open(path, "r", encoding="utf-8") as f:
        raw = json.load(f)
    return _parse_reference_blob(raw, expect_model)


def _parse_reference_blob(raw: dict, expect_model: str) -> Optional[IndexState]:
    version = int(raw.get("version", 0))
    if version < SCHEMA_VERSION:
        # Outdated: reindex to capture provenance (rag_engine.rs:1664-1673)
        raise _VersionTooOld(str(version))
    chunks = raw.get("chunks", {})
    metas: List[ChunkMeta] = []
    rows: List[np.ndarray] = []
    dim: Optional[int] = None
    for cid, c in chunks.items():
        v = np.asarray(c.get("embedding", []), dtype=np.float32)
        if dim is None:
            dim = v.shape[0]
        if v.shape[0] != dim:
            raise ValueError("inconsistent embedding dims in reference index")
        rows.append(v)
        metas.append(
            ChunkMeta(
                id=c.get("id", cid),
                document_name=c.get("document_name", ""),
                text=c.get("text", ""),
                chunk_index=int(c.get("chunk_index", 0)),
                page_number=int(c.get("page_number", 0)),
                section=c.get("section"),
                metadata=c.get("metadata") or {},
            )
        )
    emb = np.stack(rows) if rows else np.zeros((0, dim or 0), dtype=np.float32)
    _normalize_rows_inplace(emb)
    state = IndexState(
        model=raw.get("model", expect_model),
        embeddings=emb,
        metas=metas,
        needs_reindex=bool(raw.get("needs_reindex", False)),
        document_hashes=dict(raw.get("document_hashes") or {}),
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
