"""Oracle validation for scale_check (port of scripts/oracle_check.py):
re-derive the reference's hybrid scoring loop in numpy over the live
engine's state and compare rankings.

Duck-typed over the engine: store.snapshot_host(), the query cache
(embedding_service._cache.put), search() and lexical_index.score(), so it
holds the port's RagEngine and the JAX package's alike."""

from __future__ import annotations

import numpy as np

W_EMBEDDING, W_LEXICAL = 0.7, 0.3  # the reference's hybrid weights
F32_EPS = 1.1920929e-07


def validate(eng, rng, n_queries: int = 3, top_k: int = 20) -> bool:
    """True when the engine's top_k ids of `n_queries` random unit queries
    (drawn from `rng`) equal the numpy re-derivation's; prints each miss."""
    emb_rows, metas = eng.store.snapshot_host()
    id_by_row = [m.id for m in metas]

    ok = True
    for qi in range(n_queries):
        q = rng.standard_normal(emb_rows.shape[1]).astype(np.float32)
        q /= np.linalg.norm(q)

        # drive the engine with this exact embedding via the query cache
        query_text = f"__oracle_probe_{qi}__"
        eng.embedding_service._cache.put(query_text, q)

        got_ids = [r.chunk_id for r in eng.search(query_text, top_k)]

        lex_pairs = dict(eng.lexical_index.score(query_text, top_k * 5))
        emb_scores = emb_rows @ q
        lex = np.array([lex_pairs.get(cid, 0.0) for cid in id_by_row], dtype=np.float32)
        max_lex = max(float(lex.max()) if lex.size else 0.0, F32_EPS)
        combined = W_EMBEDDING * emb_scores + W_LEXICAL * (lex / max_lex)
        want_ids = [id_by_row[i] for i in np.argsort(-combined, kind="stable")[:top_k]]

        if got_ids != want_ids:
            mismatch = sum(1 for a, b in zip(got_ids, want_ids) if a != b)
            print(f"  query {qi}: {mismatch}/{top_k} rank mismatches")
            ok = False
    return ok
