"""rag-tui — terminal client for the RAG server (port of
rust_local_rag_tpu/tui/ on the standard library).

    python -m rust_local_rag_tpu_torch.tui

Python/curses counterpart of the reference's ratatui client
(src/bin/rag_tui, SURVEY.md §2.1 row 18 / §3.5): search-as-you-type with a
stale-search-id guard, result list + detail view with the full score
breakdown, background reindex trigger + job progress pushed over the MCP
SSE channel (1 s polling as the fallback), periodic stats/health probes, a
settings editor that round-trips .env preserving comments, and three color
themes. It talks to the port's server (`python -m rust_local_rag_tpu_torch`)
over the same HTTP API, through api.ApiClient on http.client. It runs no
model and launches no kernel.
"""
