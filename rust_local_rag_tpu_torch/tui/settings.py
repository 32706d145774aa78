"""Settings editor: .env round trip preserving comments and unknown keys
(cf. bin/rag_tui/settings.rs — validation at :104-178, comment-preserving
save at :456-510); a copy of rust_local_rag_tpu/tui/settings.py."""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# Editable settings surfaced by the TUI, with validators.
SETTING_KEYS = [
    ("RAG_TUI_SERVER_URL", "Server URL (http://host:port)"),
    ("MCP_HTTP_BIND", "Server bind address (host:port)"),
    ("RAG_TPU_EMBEDDING_MODEL", "Embedding model name"),
    ("RAG_TPU_RERANK_MODEL", "Rerank model name (empty disables)"),
    ("ENCODER_WEIGHTS", "Encoder checkpoint (.safetensors)"),
    ("RERANKER_WEIGHTS", "Reranker checkpoint (.safetensors)"),
    ("RAG_EMBEDDING_WEIGHT", "Embedding weight (0.0-1.0)"),
    ("RAG_LEXICAL_WEIGHT", "Lexical weight (0.0-1.0)"),
    ("RAG_RERANKER_WEIGHT", "Reranker weight (0.0-1.0)"),
    ("RAG_INITIAL_SCORE_WEIGHT", "Initial score weight (0.0-1.0)"),
    ("EMBEDDING_BATCH_SIZE", "Ingest embed batch size"),
    ("DATA_DIR", "Index data directory"),
    ("DOCUMENTS_DIR", "PDF documents directory"),
]

_WEIGHT_KEYS = {
    "RAG_EMBEDDING_WEIGHT",
    "RAG_LEXICAL_WEIGHT",
    "RAG_RERANKER_WEIGHT",
    "RAG_INITIAL_SCORE_WEIGHT",
}

# Server-side keys are read once at startup (config.py caches weights the
# way the reference's OnceLock does, rag_engine.rs:1807-1841), so editing
# them only takes effect after a restart; mirrors the reference Setting's
# requires_restart flag (settings.rs:53-55).
REQUIRES_RESTART = {k for k, _ in SETTING_KEYS} - {"RAG_TUI_SERVER_URL"}

_DIR_KEYS = {"DATA_DIR", "DOCUMENTS_DIR"}
_FILE_KEYS = {"ENCODER_WEIGHTS", "RERANKER_WEIGHTS"}

# Validation outcome: None = valid; ("warning", msg) = accepted with a
# caution; ("error", msg) = rejected. Three-state model mirrors the
# reference's ValidationState Valid/Warning/Invalid (settings.rs:104-178).
Verdict = Optional[Tuple[str, str]]


def validate(key: str, value: str) -> Verdict:
    if value == "":
        return None  # empty clears the override
    if key in _WEIGHT_KEYS:
        # settings.rs:153-173: finite f32 in [0, 1]
        try:
            w = float(value)
        except ValueError:
            return ("error", "invalid number format")
        import math

        if not math.isfinite(w):
            return ("error", "weight must be a finite number (not NaN or Inf)")
        if not (0.0 <= w <= 1.0):
            return ("error", "weight must be between 0.0 and 1.0")
        return None
    if key == "EMBEDDING_BATCH_SIZE":
        try:
            n = int(value)
        except ValueError:
            return ("error", "must be an integer")
        if n < 1:
            return ("error", "must be >= 1")
        return None
    if key == "MCP_HTTP_BIND":
        host, sep, port = value.rpartition(":")
        if not sep or not host:
            return ("error", "must be host:port")
        try:
            p = int(port)
        except ValueError:
            return ("error", "port must be a number")
        if not (0 < p < 65536):
            return ("error", "port out of range")
        return None
    if key == "RAG_TUI_SERVER_URL":
        # settings.rs:107-118 (URL validation for the model-server URL)
        v = value.strip()
        if not (v.startswith("http://") or v.startswith("https://")):
            return ("error", "URL must start with http:// or https://")
        from urllib.parse import urlparse

        parsed = urlparse(v)
        if not parsed.netloc:
            return ("error", "invalid URL format")
        return None
    if key in _DIR_KEYS:
        # settings.rs:121-150 (exists-not-dir invalid; missing -> warning;
        # unexpandable tilde -> warning)
        expanded = os.path.expanduser(value.strip())
        if value.strip().startswith("~") and expanded == value.strip():
            return ("warning", "tilde (~) may not expand; use absolute path")
        if os.path.exists(expanded):
            if not os.path.isdir(expanded):
                return ("error", "path exists but is not a directory")
            return None
        return ("warning", "directory does not exist (will be created)")
    if key in _FILE_KEYS:
        expanded = os.path.expanduser(value.strip())
        if os.path.isdir(expanded):
            return ("error", "path is a directory, expected a file")
        if not os.path.exists(expanded):
            return ("warning", "checkpoint file does not exist")
        return None
    return None


@dataclass
class Settings:
    """Values + the raw .env lines they came from."""

    path: str = ".env"
    values: Dict[str, str] = field(default_factory=dict)
    _lines: List[str] = field(default_factory=list)
    _saved: Dict[str, str] = field(default_factory=dict)

    @classmethod
    def load(cls, path: str = ".env") -> "Settings":
        s = cls(path=path)
        try:
            with open(path, "r", encoding="utf-8") as f:
                s._lines = f.read().splitlines()
        except OSError:
            s._lines = []
        for line in s._lines:
            stripped = line.strip()
            if not stripped or stripped.startswith("#") or "=" not in stripped:
                continue
            key, _, val = stripped.partition("=")
            s.values[key.strip()] = val.strip().strip("\"'")
        s._saved = dict(s.values)
        return s

    def is_modified(self, key: str) -> bool:
        """True when the in-editor value differs from what the .env file
        holds (reference Setting::is_modified, settings.rs:88-90)."""
        return self.values.get(key, "") != self._saved.get(key, "")

    def requires_restart(self, key: str) -> bool:
        return key in REQUIRES_RESTART

    def get(self, key: str) -> str:
        return self.values.get(key, os.environ.get(key, ""))

    def set(self, key: str, value: str) -> Optional[str]:
        """Apply a value. Returns None (ok), a "warning: ..." string (value
        WAS applied), or an error string (value rejected)."""
        verdict = validate(key, value)
        if verdict is not None and verdict[0] == "error":
            return verdict[1]
        if value == "":
            self.values.pop(key, None)
        else:
            self.values[key] = value
        if verdict is not None:
            return f"warning: {verdict[1]}"
        return None

    def save(self) -> None:
        """Rewrite .env: update known keys in place, keep comments and
        unknown keys verbatim, append new keys at the end."""
        seen = set()
        out: List[str] = []
        for line in self._lines:
            stripped = line.strip()
            if stripped and not stripped.startswith("#") and "=" in stripped:
                key = stripped.partition("=")[0].strip()
                if key in self.values:
                    out.append(f"{key}={self.values[key]}")
                    seen.add(key)
                    continue
                if key in {k for k, _ in SETTING_KEYS}:
                    # key was cleared by the editor: drop the line
                    seen.add(key)
                    continue
            out.append(line)
        for key, value in self.values.items():
            if key not in seen:
                out.append(f"{key}={value}")
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write("\n".join(out) + ("\n" if out else ""))
        os.replace(tmp, self.path)
        self._lines = out
        self._saved = dict(self.values)  # mark_saved (settings.rs:98-100)

    def rows(self) -> List[Tuple[str, str, str]]:
        """(key, description, current value) for the editor."""
        return [(k, desc, self.get(k)) for k, desc in SETTING_KEYS]
