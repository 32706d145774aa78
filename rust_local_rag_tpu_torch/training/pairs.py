"""Contrastive pair construction from tokenized paragraphs (port of
rust_local_rag_tpu/training/pairs.py; numpy only, so the same seed,
paragraphs and tokenizer give the JAX package's arrays).

Two recipes over a corpus tokenized ONCE up front (crops are cheap integer
slices; batches are fixed-shape int32 arrays for the train step):

* symmetric (Contriever): two independent crops of one paragraph are a
  positive pair. Measured result (round 2): great crop<->crop retrieval
  (0.55 top-1 @ 1024) but it does NOT transfer to short-question ->
  long-passage search (0.29 hit@5 on the quality eval) — both sides look
  like passages.
* asymmetric (ICT, inverse cloze task — the default for the serving
  encoder): the "query" side is a SHORT crop (question-length), the
  positive is the SURROUNDING paragraph with the query span usually
  removed, padded to passage length. This matches the serving distribution
  (short queries against ~200-token chunks) and forces semantic rather
  than copy matching.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

CROP_MIN = 12
CROP_MAX = 56
SEQ_LEN = 64

# asymmetric (ICT) geometry
Q_MIN, Q_MAX = 4, 16          # query crop, wordpieces
Q_LEN = 32                    # query pad length
P_LEN = 128                   # passage pad length
ICT_KEEP_PROB = 0.2           # keep the query span inside the passage


def bm25_neighbors(texts: Sequence[str], indexed: Sequence[int], crops: Sequence[str], n_neighbors: int,
                   threads: int = 8) -> np.ndarray:
    """[len(crops), n_neighbors] int32 table, -1 padded: row i holds the top
    BM25 hits for crops[i] among the paragraphs `indexed` (indices into
    texts, added in that order), paragraph i itself left out.

    Each worker thread builds its own index over the same paragraphs, in
    one add_chunks call, and scores its span of crops: a native index
    scores one query at a time (it keeps its scratch per handle), and its
    C calls release the GIL. The table does not depend on the thread
    count."""
    from concurrent.futures import ThreadPoolExecutor

    from rust_local_rag_tpu_torch.ops.native_bm25 import make_lexical_index

    n = len(crops)
    out = np.full((n, n_neighbors), -1, dtype=np.int32)
    threads = max(1, min(threads, os.cpu_count() or 1, n))
    ids = [str(i) for i in indexed]
    paragraphs = [texts[i] for i in indexed]

    def mine(span):
        lo, hi = span
        bm25 = make_lexical_index()
        bm25.add_chunks(ids, paragraphs)
        for i in range(lo, hi):
            hits = bm25.score(crops[i], n_neighbors + 1)
            cands = [int(c) for c, _ in hits if int(c) != i]
            out[i, : len(cands[:n_neighbors])] = cands[:n_neighbors]

    step = (n + threads - 1) // threads
    spans = [(lo, min(lo + step, n)) for lo in range(0, n, step)]
    with ThreadPoolExecutor(threads) as ex:
        list(ex.map(mine, spans))
    return out


class PairBatcher:
    def __init__(
        self,
        paragraphs: Sequence[str],
        tokenizer,
        seq_len: int = SEQ_LEN,
        seed: int = 0,
        query_prefix: str = "",
        doc_prefix: str = "",
    ):
        """`tokenizer`: the port's WordPiece tokenizer (native or pure
        Python: token_to_id, tokenize_full, tokenize_full_batch), the
        counterpart of the HuggingFace tokenizer the JAX batcher reads."""
        self.seq_len = seq_len
        self.rng = np.random.default_rng(seed)
        tk = tokenizer
        self.cls_id = tk.token_to_id("[CLS]")
        self.sep_id = tk.token_to_id("[SEP]")
        self.pad_id = tk.token_to_id("[PAD]")

        def _prefix_ids(text: str) -> np.ndarray:
            if not text:
                return np.zeros((0,), dtype=np.int32)
            ids = [
                i
                for i in tk.tokenize_full(text)
                if i not in (self.cls_id, self.sep_id)
            ]
            return np.asarray(ids, dtype=np.int32)

        # dual task prefixes (nomic-embed-text-class): queries and
        # documents carry different markers so the encoder can separate
        # the two registers
        self.q_prefix = _prefix_ids(query_prefix)
        self.d_prefix = _prefix_ids(doc_prefix)
        # tokenize once, strip specials, keep paragraphs long enough to crop
        self.docs: List[np.ndarray] = []
        self.texts: List[str] = []  # aligned with self.docs (for mining)
        # one batch encode: the native tokenizer, not a Python loop
        encs = tk.tokenize_full_batch(list(paragraphs))
        for text, e in zip(paragraphs, encs):
            ids = [i for i in e if i not in (self.cls_id, self.sep_id)]
            if len(ids) >= CROP_MIN + 4:
                self.docs.append(np.asarray(ids, dtype=np.int32))
                self.texts.append(text)
        if not self.docs:
            raise ValueError("no paragraphs long enough to crop")
        # [D, n] int32 BM25-neighbor table (premine_hard_negatives), -1 pad
        self.neighbors: Optional[np.ndarray] = None
        # optional [D, n] table mined by the committed dense encoder and
        # denoised by the committed reranker (training/mining.py, encoder
        # v5 recipe); when present, half the mined negatives draw from it
        self.dense_neighbors: Optional[np.ndarray] = None

    def _crop(self, ids: np.ndarray) -> np.ndarray:
        n = len(ids)
        ln = int(self.rng.integers(CROP_MIN, min(CROP_MAX, n) + 1))
        start = int(self.rng.integers(0, n - ln + 1))
        return ids[start : start + ln]

    def _pack(self, crops: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
        B = len(crops)
        out = np.full((B, self.seq_len), self.pad_id, dtype=np.int32)
        mask = np.zeros((B, self.seq_len), dtype=np.int32)
        for i, c in enumerate(crops):
            c = c[: self.seq_len - 2]
            row = np.concatenate(
                ([self.cls_id], c, [self.sep_id])
            ).astype(np.int32)
            out[i, : len(row)] = row
            mask[i, : len(row)] = 1
        return out, mask

    def batch(self, batch_size: int):
        """-> (q_ids, q_mask, p_ids, p_mask), each [B, L] int32."""
        idx = self.rng.integers(0, len(self.docs), size=batch_size)
        qs = [self._crop(self.docs[i]) for i in idx]
        ps = [self._crop(self.docs[i]) for i in idx]
        q_ids, q_mask = self._pack(qs)
        p_ids, p_mask = self._pack(ps)
        return q_ids, q_mask, p_ids, p_mask

    def stacked_batches(self, n_steps: int, batch_size: int):
        """[S, B, L] arrays for a multi-step dispatch (S optimizer steps a
        call of parallel/train.make_optax_scan_step)."""
        qi, qm, pi, pm = [], [], [], []
        for _ in range(n_steps):
            a, b, c, d = self.batch(batch_size)
            qi.append(a)
            qm.append(b)
            pi.append(c)
            pm.append(d)
        return (
            np.stack(qi),
            np.stack(qm),
            np.stack(pi),
            np.stack(pm),
        )

    def _pack_len(
        self,
        crops: List[np.ndarray],
        seq_len: int,
        prefix: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        B = len(crops)
        pre = (
            prefix
            if prefix is not None
            else np.zeros((0,), dtype=np.int32)
        )
        out = np.full((B, seq_len), self.pad_id, dtype=np.int32)
        mask = np.zeros((B, seq_len), dtype=np.int32)
        for i, c in enumerate(crops):
            c = c[: seq_len - 2 - len(pre)]
            row = np.concatenate(
                ([self.cls_id], pre, c, [self.sep_id])
            ).astype(np.int32)
            out[i, : len(row)] = row
            mask[i, : len(row)] = 1
        return out, mask

    def _ict_pair(self, ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        n = len(ids)
        qlen = int(self.rng.integers(Q_MIN, min(Q_MAX, n - 8) + 1))
        start = int(self.rng.integers(0, n - qlen + 1))
        q = ids[start : start + qlen]
        if self.rng.random() < ICT_KEEP_PROB:
            p = ids
        else:
            p = np.concatenate([ids[:start], ids[start + qlen :]])
        return q, p

    def ict_batch(self, batch_size: int, p_len: int = P_LEN):
        """Asymmetric batch: (q_ids [B, Q_LEN], q_mask, p_ids [B, p_len],
        p_mask) — short query crops against their source passages."""
        idx = self.rng.integers(0, len(self.docs), size=batch_size)
        qs, ps = [], []
        for i in idx:
            q, p = self._ict_pair(self.docs[i])
            qs.append(q)
            ps.append(p)
        q_ids, q_mask = self._pack_len(qs, Q_LEN, self.q_prefix)
        p_ids, p_mask = self._pack_len(ps, p_len, self.d_prefix)
        return q_ids, q_mask, p_ids, p_mask

    def mixed_batch(self, batch_size: int, p_len: int = P_LEN):
        """Mixed-objective asymmetric batch; per example:
          50% ICT          — random short crop vs passage-with-gap;
          25% lead->rest   — the paragraph's opening span (docstring
                             summary lines read like search queries:
                             "Compute the arithmetic mean ...") vs the rest;
          25% crop<->crop  — two independent crops (robustness; both carry
                             their side's task prefix).
        """
        idx = self.rng.integers(0, len(self.docs), size=batch_size)
        qs, ps = [], []
        for i in idx:
            ids = self.docs[i]
            r = self.rng.random()
            if r < 0.5:
                q, p = self._ict_pair(ids)
            elif r < 0.75:
                qlen = min(int(self.rng.integers(Q_MIN, Q_MAX + 1)), len(ids) - 8)
                q, p = ids[:qlen], ids[qlen:]
            else:
                q = self._crop(ids)[: Q_LEN - 2 - len(self.q_prefix)]
                p = self._crop(ids)
            qs.append(q)
            ps.append(p)
        q_ids, q_mask = self._pack_len(qs, Q_LEN, self.q_prefix)
        p_ids, p_mask = self._pack_len(ps, p_len, self.d_prefix)
        return q_ids, q_mask, p_ids, p_mask

    def premine_hard_negatives(
        self,
        index_size: int = 50000,
        n_neighbors: int = 4,
        threads: int = 8,
    ) -> None:
        """Pre-mine a [D, n_neighbors] BM25-neighbor table over self.docs.

        Same recipe the reranker trainer proved out (train_reranker.py
        header, v2 lesson): per-example live BM25 queries are ~60 ms of
        host time each, so each doc is mined ONCE against a canonical
        word crop; the mined neighbor is the keyword-trap paragraph that
        shares the source's vocabulary, which is exactly the in-batch
        confusable the serving hybrid pool surfaces. -1 = no mined hit
        (batching falls back to a random negative).
        """
        import hashlib
        import time as _time

        # ~30 min of single-core host time at 184k docs: cache the table
        # on disk keyed by (corpus, mining params, rng position); the
        # "torch" prefix keeps the port and the JAX package apart
        h = hashlib.sha256()
        h.update(f"torch|{index_size}|{n_neighbors}|".encode())
        h.update(str(self.rng.bit_generator.state).encode())
        for t in self.texts:
            h.update(t.encode())
            h.update(b"\0")
        cache = os.path.join(
            os.path.expanduser("~"), ".cache", "rag_tpu_premine",
            "torch_" + h.hexdigest()[:24] + ".npy",
        )
        if os.path.exists(cache):
            self.neighbors = np.load(cache)
            # keep the rng stream identical to the mining path
            self.rng.permutation(len(self.texts))
            self.rng.integers(2**31)
            print(f"premine cache hit: {cache}")
            return

        sample = self.rng.permutation(len(self.texts))[:index_size]
        n = len(self.texts)
        crop_rng = np.random.default_rng(int(self.rng.integers(2**31)))
        crops = []
        for p in self.texts:
            words = p.split()
            qlen = int(crop_rng.integers(3, 13))
            start = int(crop_rng.integers(0, max(len(words) - qlen, 1)))
            crops.append(" ".join(words[start : start + qlen]))
        t0 = _time.monotonic()
        out = bm25_neighbors(self.texts, [int(i) for i in sample], crops, n_neighbors, threads)
        print(
            f"pre-mined {n} docs x {n_neighbors} BM25 hard negatives "
            f"in {_time.monotonic() - t0:.1f}s"
        )
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        tmp = cache + ".tmp"
        with open(tmp, "wb") as f:
            np.save(f, out)
        os.replace(tmp, cache)
        self.neighbors = out

    def premine_dense_negatives(
        self, n_neighbors: int = 4, margin: float = 0.0, device="cuda"
    ) -> dict:
        """Mine a [D, n_neighbors] dense-neighbor table with the committed
        encoder and denoise it with the committed reranker on `device`
        (encoder v5 recipe, mining.cached_denoised_table — disk-cached;
        remining is ~15 min of device time). Returns the denoise stats."""
        from rust_local_rag_tpu_torch.training.mining import cached_denoised_table

        self.dense_neighbors, stats = cached_denoised_table(
            self.texts, n_neighbors=n_neighbors, margin=margin, device=device
        )
        return stats

    def _negative_index(self, i: int) -> int:
        """A mined neighbor of doc i (50/50 BM25 keyword trap vs denoised
        dense near-miss when both tables exist), or a random other doc."""
        rows = []
        if self.neighbors is not None:
            rows.append(self.neighbors[i])
        if self.dense_neighbors is not None:
            rows.append(self.dense_neighbors[i])
            if len(rows) == 2 and self.rng.random() < 0.5:
                rows.reverse()  # try the dense table first
        for row in rows:  # denoised rows may be empty: fall through
            cands = row[(row >= 0) & (row != i)]
            if len(cands):
                return int(cands[self.rng.integers(0, len(cands))])
        j = int(self.rng.integers(0, len(self.docs) - 1))
        return j + (j >= i)

    def mixed_hn_batch(self, batch_size: int, p_len: int = P_LEN):
        """mixed_batch plus a hard-negative passage per example:
        -> (q_ids, q_mask, p_ids, p_mask, n_ids, n_mask). The negative is
        a random crop of a BM25 neighbor of the SOURCE doc, packed at the
        same passage length (DPR-style explicit hard negatives on top of
        the in-batch ones)."""
        idx = self.rng.integers(0, len(self.docs), size=batch_size)
        qs, ps, ns = [], [], []
        for i in idx:
            ids = self.docs[i]
            r = self.rng.random()
            if r < 0.5:
                q, p = self._ict_pair(ids)
            elif r < 0.75:
                qlen = min(int(self.rng.integers(Q_MIN, Q_MAX + 1)), len(ids) - 8)
                q, p = ids[:qlen], ids[qlen:]
            else:
                q = self._crop(ids)[: Q_LEN - 2 - len(self.q_prefix)]
                p = self._crop(ids)
            qs.append(q)
            ps.append(p)
            nd = self.docs[self._negative_index(int(i))]
            # full lead slice, not a random crop: serving passages start
            # at sentence boundaries, and the lead carries the heading-ish
            # context BM25 matched on
            ns.append(nd)
        q_ids, q_mask = self._pack_len(qs, Q_LEN, self.q_prefix)
        p_ids, p_mask = self._pack_len(ps, p_len, self.d_prefix)
        n_ids, n_mask = self._pack_len(ns, p_len, self.d_prefix)
        return q_ids, q_mask, p_ids, p_mask, n_ids, n_mask

    def mixed_hn_stacked_batches(
        self, n_steps: int, batch_size: int, p_len: int = P_LEN
    ):
        cols = [[] for _ in range(6)]
        for _ in range(n_steps):
            for col, arr in zip(cols, self.mixed_hn_batch(batch_size, p_len)):
                col.append(arr)
        return tuple(np.stack(c) for c in cols)

    def mixed_stacked_batches(
        self, n_steps: int, batch_size: int, p_len: int = P_LEN
    ):
        qi, qm, pi, pm = [], [], [], []
        for _ in range(n_steps):
            a, b, c, d = self.mixed_batch(batch_size, p_len)
            qi.append(a)
            qm.append(b)
            pi.append(c)
            pm.append(d)
        return np.stack(qi), np.stack(qm), np.stack(pi), np.stack(pm)

    def ict_stacked_batches(
        self, n_steps: int, batch_size: int, p_len: int = P_LEN
    ):
        qi, qm, pi, pm = [], [], [], []
        for _ in range(n_steps):
            a, b, c, d = self.ict_batch(batch_size, p_len)
            qi.append(a)
            qm.append(b)
            pi.append(c)
            pm.append(d)
        return np.stack(qi), np.stack(qm), np.stack(pi), np.stack(pm)

    def ict_eval_bank(self, n: int):
        """Deterministic short-query -> passage bank: the first sentence-ish
        span of each doc queries against the remainder."""
        n = min(n, len(self.docs))
        qs, ps = [], []
        for i in range(n):
            ids = self.docs[i]
            qlen = min(Q_MAX, max(Q_MIN, len(ids) // 6))
            qs.append(ids[:qlen])
            ps.append(ids[qlen:])
        q_ids, q_mask = self._pack_len(qs, Q_LEN, self.q_prefix)
        p_ids, p_mask = self._pack_len(ps, P_LEN, self.d_prefix)
        return q_ids, q_mask, p_ids, p_mask

    def eval_bank(self, n: int, start_frac: float = 0.0):
        """Deterministic (query-crop, positive-crop) bank from the first n
        suitable docs — retrieval accuracy over this bank is the held-out
        training metric (crop A must retrieve crop B among n candidates)."""
        rng = np.random.default_rng(12345)
        n = min(n, len(self.docs))
        qs, ps = [], []
        for i in range(n):
            ids = self.docs[i]
            m = len(ids)
            half = max(CROP_MIN, m // 2)
            qs.append(ids[: min(half, CROP_MAX)])
            ps.append(ids[m - min(half, CROP_MAX) :])
        q_ids, q_mask = self._pack(qs)
        p_ids, p_mask = self._pack(ps)
        return q_ids, q_mask, p_ids, p_mask
