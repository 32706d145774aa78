"""The plain reference of a served search, and the comparison that judges
a served answer against it.

A request's answer, as the system defines it (rag_engine.rs:480-839):

  1. the query embedding q (reference encoder, query prefix) and, for every
     chunk, the dense score e = q . row (f64 of the rows as stored);
  2. BM25 over the chunks; only the top `5 * pool` hits count, each
     normalised by the best hit: lexn = bm25 / max bm25, 0 elsewhere;
  3. the initial score c = w_e * e + w_l * lexn;
  4. with the judge: the top 3 * pool chunks by c are judged, and
     s = w_r * rr / max rr + w_i * c / max c (rr the yes-probability);
     the answer's pool is the top `pool` by s; without it, by c;
  5. diversity 0 gives the top `top_k` of the pool; diversity lambda > 0
     gives greedy MMR over the pool: the first pick is the best, then
     argmax (1 - lambda) * rel - lambda * max(0, max similarity to the
     picks), rel being s (judged) or c.

pool = top_k at diversity 0, else max(3 * top_k, top_k + 10).

Exact ties are part of the definition: which of two chunks with equal BM25
at the hit list's edge gets its boost is arbitrary, and that choice can
move a chunk into or out of the judged set and change the blend's
normalisers. The comparison therefore reads the set of values the
definition allows for each chunk (lowest and highest lexn and c; every s
the possible normalisers give), the chunks that may be in each pool
(`possible`) and those that are in it whatever the ties (`certain`): a
served value is measured against the nearest allowed one, and a served
choice against the best lowest value among the certain candidates it
passed over.

Rounding ties too, where the configuration states them (its `ties`: how
far the program at the deployment's stated precision, rounding in
another order, may move a dense score, `dense_score`, and the judge's
yes-over-no logit, `judge_logit`, from this reference's). A chunk within
the dense tie of the judged set's edge may fall on either side of it,
and the judge's weight then carries it into or out of the answer. Each
judged chunk's yes-probability, and with them the blend's normaliser,
may take any value that a logit difference within the judge's tie of the
reference's gives: a served blended score is held to the range of the
values those give, and a served choice to the lowest of them. Without
`ties` every comparison is exact up to the ties of the definition.

The numbers a served answer gives (the worst over its results):
  * score_gap: |served - reference| of initial_score, embedding_score,
    lexical_score and, without the judge, score;
  * with the judge, blend_gap: how far the served blended score lies
    from the values allowed (outside their range, where the judge has a
    tie: its rounding, magnified by 1 / the judged set's best
    yes-probability, reaches the blend, so it has a limit of its own),
    and judge_gap: |served - reference| of yes_logprob and no_logprob;
  * choice_gap: at each step, the best objective among the certain
    candidates the answer passed over minus the objective of the one it
    took (0 for the reference's own choice), and how far a served
    result lies below the lowest edge of the judged set (by c) or of the
    pool (by s);
  * short: 1 when it has fewer results than the reference gives.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np
import torch

from reference import models
from reference.bm25 import Bm25
from reference.tokenizer import WordPieceTokenizer, bucket_batch

F32_EPSILON = 1.1920929e-07
# BM25 scores that the system sums in f32 may differ from the f64 ones by
# this share of the best hit; hits that close to the edge are ties
LEX_TIE = 1e-5
JUDGE_BATCH = 256


@dataclass
class Lane:
    """What a request body asks for, with the deployment's weights."""

    top_k: int
    diversity: float
    use_reranker: bool
    w_embedding: float
    w_lexical: float
    w_reranker: float
    w_initial: float

    @property
    def pool(self) -> int:
        return self.top_k if self.diversity == 0.0 else max(3 * self.top_k, self.top_k + 10)


def lane_for(body: dict, weights: dict, has_judge: bool) -> Lane:
    """The lane of a /search body under the server's defaults (top_k 5,
    diversity 0.3, use_reranker true)."""
    lane = Lane(top_k=int(body.get("top_k", 5)), diversity=min(max(float(body.get("diversity_factor", 0.3)), 0.0), 1.0),
                use_reranker=bool(body.get("use_reranker", True)) and has_judge,
                w_embedding=weights["embedding"], w_lexical=weights["lexical"],
                w_reranker=weights["reranker"], w_initial=weights["initial"])
    if lane.use_reranker and lane.w_reranker == 0.0:
        raise NotImplementedError("the judge-gated lane (reranker weight 0) has no reference here yet")
    return lane


@dataclass
class Corpus:
    """What both sides are given: the rows as stored, the BM25 inputs, and
    each chunk's text, id, document and page."""

    rows: torch.Tensor          # [N, D] in the stored dtype, unit rows
    bm25: Bm25
    texts: Sequence[str]
    ids: Sequence[str]
    documents: Sequence[str]
    pages: Sequence[int]

    def __post_init__(self):
        self.index = {cid: i for i, cid in enumerate(self.ids)}
        self.rows64 = self.rows.double()


class Reference:
    def __init__(self, corpus: Corpus, encoder: models.Model, tokenizer: WordPieceTokenizer, judge,
                 template: str, fp8: bool = False, ties: dict = None):
        """`judge`: what the configuration's judge module loads (see
        reference/judge_tpu_reranker.py), or None; `ties`: the
        configuration's (see the module docstring)."""
        self.c = corpus
        self.encoder = encoder
        self.tok = tokenizer
        self.judge_model = judge
        self.template = template
        self.fp8 = fp8
        ties = ties or {}
        self.dense_tie = float(ties.get("dense_score", 0.0))
        self.logit_tie = float(ties.get("judge_logit", 0.0))
        self.device = corpus.rows.device
        self.query_prefix = encoder.meta.get("query_prefix", "")
        self.judged_tokens = []  # valid tokens of every prompt judged

    # ----- the models -----

    def embed_queries(self, queries: Sequence[str]) -> torch.Tensor:
        """[n, D] f64 query embeddings, one batch padded as the system pads."""
        ids, mask = self.tok.encode_batch([self.query_prefix + q for q in queries])
        nb = bucket_batch(len(queries))
        if nb > len(queries):
            ids = np.concatenate([ids, np.zeros((nb - len(queries), ids.shape[1]), ids.dtype)])
            mask = np.concatenate([mask, np.zeros((nb - len(queries), mask.shape[1]), mask.dtype)])
            mask[len(queries):, 0] = 1
        out = models.encode(self.encoder, torch.from_numpy(ids).to(self.device),
                            torch.from_numpy(mask).to(self.device), fp8=self.fp8)
        return out[:len(queries)].double()

    def prompt(self, query: str, i: int) -> str:
        page = "unknown" if self.c.pages[i] == 0 else str(self.c.pages[i])
        return (self.template.replace("{query}", query.strip()).replace("{document}", self.c.documents[i])
                .replace("{page}", page).replace("{section}", "N/A").replace("{text}", self.c.texts[i].strip()))

    def judge(self, query: str, chunks: Sequence[int]) -> Dict[int, tuple]:
        """{chunk: (yes logprob, no logprob, yes-probability)}."""
        out = {}
        chunks = list(chunks)
        for lo in range(0, len(chunks), JUDGE_BATCH):
            part = chunks[lo:lo + JUDGE_BATCH]
            yes, no, valid = self.judge_model.score([self.prompt(query, i) for i in part], fp8=self.fp8)
            self.judged_tokens.extend(valid)
            for i, y, n in zip(part, yes, no):
                out[i] = (y, n, models.yes_probability(y, n))
        return out

    # ----- the definition -----

    def _plan(self, query: str, terms, q: torch.Tensor, lane: Lane, tie: bool = False) -> dict:
        """Every chunk's e, and lexn and c at their lowest and highest
        allowed values; with the judge, the chunks that may be in the 3 *
        pool the system judges (`possible`), those that are in it whatever
        the ties (`certain`), and each possible chunk's judge reading (with
        `tie`, the judged set's edge widened by the dense tie and the
        readings allowed to move by the judge's logit tie)."""
        e = (self.c.rows64 @ q).cpu().numpy()
        bm = self.c.bm25.scores(terms)
        limit = 5 * lane.pool
        best = float(bm.max()) if bm.size else 0.0
        positive = bm[bm > 0]
        edge = float(np.partition(positive, positive.size - limit)[positive.size - limit]) \
            if positive.size > limit else 0.0
        tol = LEX_TIE * max(best, F32_EPSILON)
        norm = bm / max(best, F32_EPSILON)
        lex_hi = np.where(bm >= edge - tol, norm, 0.0)
        lex_lo = np.where(bm > edge + tol, norm, 0.0) if edge > 0 else lex_hi
        p = {"e": e, "lex_lo": lex_lo, "lex_hi": lex_hi,
             "c_lo": lane.w_embedding * e + lane.w_lexical * lex_lo,
             "c_hi": lane.w_embedding * e + lane.w_lexical * lex_hi, "judged": {}}
        if not lane.use_reranker:
            order = np.argsort(-p["c_lo"], kind="stable")[:lane.pool + 64].tolist()
            p["possible"] = p["certain"] = order
            return p
        n_init = min(len(e), 3 * lane.pool)
        kth = lambda x: float(np.partition(x, len(x) - n_init)[len(x) - n_init])  # noqa: E731
        t_lo, t_hi = kth(p["c_lo"]), kth(p["c_hi"])
        p["possible"] = np.flatnonzero(p["c_hi"] >= t_lo).tolist()
        p["certain"] = np.flatnonzero(p["c_lo"] >= t_hi).tolist()
        # a chunk's initial score and the edge's each may round by w_e * the dense tie: the judged set is then
        # certain of a chunk only above the best of the rest by twice that
        edge = 2 * lane.w_embedding * self.dense_tie if tie else 0.0
        if edge and len(e) > n_init:
            t_lo -= edge
            rest = float(np.partition(p["c_hi"], len(e) - n_init - 1)[len(e) - n_init - 1])
            p["possible"] = np.flatnonzero(p["c_hi"] >= t_lo).tolist()
            # (where every candidate lies that close to the rest, the ties at the edge alone decide)
            p["certain"] = np.flatnonzero(p["c_lo"] > rest + edge).tolist() or p["certain"]
        p["t_lo"] = t_lo
        p["judged"] = {int(i): v for i, v in self.judge(query, p["possible"]).items()}
        p["tie"] = self.logit_tie if tie else 0.0
        # blend normalisers: the best yes-probability and initial score of
        # the judged set, which ties at its edge (and the judge's) can change
        top_rr = max(p["judged"][i][2] for i in p["certain"])
        norm = [top_rr] + [p["judged"][i][2] for i in p["possible"] if p["judged"][i][2] > top_rr]
        if p["tie"]:
            norm += [max(self._rrs(p, i)[0] for i in p["certain"]), max(self._rrs(p, i)[-1] for i in p["possible"])]
        p["norm_rr"] = sorted({max(r, F32_EPSILON) for r in norm})
        p["norm_c"] = sorted({max(float(p["c_lo"][p["certain"]].max()), F32_EPSILON),
                              max(float(p["c_hi"][p["possible"]].max()), F32_EPSILON)})
        return p

    @staticmethod
    def _rrs(p: dict, i: int) -> List[float]:
        """A judged chunk's yes-probability, at the ends of the judge's tie
        where the plan has one."""
        y, n, rr = p["judged"][i]
        t = p.get("tie", 0.0)
        return [models.yes_probability(y - t, n), rr, models.yes_probability(y + t, n)] if t else [rr]

    def _values(self, p: dict, lane: Lane, i: int, query: str) -> List[float]:
        """The values a chunk's rel (s with the judge, else c) may take."""
        cs = {float(p["c_lo"][i]), float(p["c_hi"][i])}
        if not lane.use_reranker:
            return sorted(cs)
        if i not in p["judged"]:
            p["judged"].update(self.judge(query, [i]))
        return sorted({lane.w_reranker * rr / n + lane.w_initial * c / m
                       for rr in self._rrs(p, i) for n in p["norm_rr"] for m in p["norm_c"] for c in cs})

    def _pools(self, p: dict, lane: Lane, query: str):
        """(the pool the answer may be drawn from, the chunks in it whatever
        the ties, the pool's lowest edge), by rel."""
        vals = {i: self._values(p, lane, i, query) for i in p["possible"]}
        if not lane.use_reranker:
            order = sorted(p["possible"], key=lambda i: -vals[i][0])
            return order, order, -np.inf
        k = min(lane.pool, len(p["certain"]))
        r_lo = sorted((vals[i][0] for i in p["certain"]), reverse=True)[k - 1]
        r_hi = sorted((vals[i][-1] for i in p["possible"]), reverse=True)[k - 1]
        possible = [i for i in p["possible"] if vals[i][-1] >= r_lo]
        certain = sorted((i for i in p["certain"] if vals[i][0] >= r_hi), key=lambda i: -vals[i][0])
        return possible, certain, r_lo

    def answer(self, query: str, terms, q: torch.Tensor, lane: Lane) -> List[dict]:
        """The reference's own answer (results as the server writes them),
        each tie taken at its lowest value."""
        p = self._plan(query, terms, q, lane)
        cand = p["certain"] if not lane.use_reranker else p["possible"]
        rel = {i: self._values(p, lane, i, query)[0] for i in cand}
        pool = sorted(cand, key=lambda i: -rel[i])[:lane.pool]
        picks = self._greedy(pool, rel, lane)
        out = []
        for i in picks:
            r = {"chunk_id": self.c.ids[i], "embedding_score": float(p["e"][i]),
                 "lexical_score": float(p["lex_lo"][i])}
            if lane.use_reranker:
                y, n, rr = p["judged"][i]
                r.update(score=rel[i], initial_score=float(p["c_lo"][i]), reranker_score=rr, yes_logprob=y,
                         no_logprob=n)
            else:
                r.update(score=float(p["c_lo"][i]), initial_score=float(p["c_lo"][i]))
            out.append(r)
        return out

    def _greedy(self, pool: List[int], rel: Dict[int, float], lane: Lane) -> List[int]:
        if lane.diversity == 0.0:
            return pool[:lane.top_k]
        picks = [pool[0]]
        while len(picks) < min(lane.top_k, len(pool)):
            rest = [i for i in pool if i not in picks]
            sims = self._max_sims(rest, picks)
            obj = [(1 - lane.diversity) * rel[i] - lane.diversity * s for i, s in zip(rest, sims)]
            picks.append(rest[int(np.argmax(obj))])
        return picks

    def _max_sims(self, cand: List[int], picks: List[int]) -> List[float]:
        a = self.c.rows64[torch.as_tensor(cand, device=self.device)]
        b = self.c.rows64[torch.as_tensor(picks, device=self.device)]
        return torch.clamp((a @ b.T).amax(dim=1), min=0.0).cpu().tolist()

    def judge_answer(self, query: str, terms, q: torch.Tensor, lane: Lane, served: List[dict]) -> dict:
        """The numbers of one served answer (see the module docstring)."""
        p = self._plan(query, terms, q, lane, tie=True)
        possible, certain, edge = self._pools(p, lane, query)
        expect = min(lane.top_k, len(certain) if lane.use_reranker else len(p["possible"]))
        out = {"score_gap": 0.0, "judge_gap": 0.0, "choice_gap": 0.0,
               "short": 1.0 if len(served) < expect else 0.0, "where": None}
        if lane.use_reranker:
            out["blend_gap"] = 0.0
        idx = []
        for r in served:
            i = self.c.index.get(r.get("chunk_id"))
            if i is None:
                out["choice_gap"] = float("inf")
                return out
            idx.append(i)
        if len(set(idx)) < len(idx):
            out["choice_gap"] = float("inf")

        def near(v, allowed):
            """The allowed value nearest to v."""
            return min(allowed, key=lambda a: abs(v - a))

        def within(v, allowed):
            """v held to the range of the allowed values (the judge's tie
            makes a range of them)."""
            return min(max(v, allowed[0]), allowed[-1]) if p.get("tie") else near(v, allowed)

        rel = [within(r["score"], self._values(p, lane, i, query)) for r, i in zip(served, idx)]
        for r, i, v in zip(served, idx, rel):
            lex = near(r["lexical_score"], [p["lex_lo"][i], p["lex_hi"][i]])
            gaps = [abs(r["embedding_score"] - p["e"][i]), abs(r["lexical_score"] - lex)]
            if "initial_score" in r:
                gaps.append(abs(r["initial_score"] - near(r["initial_score"], [p["c_lo"][i], p["c_hi"][i]])))
            if not lane.use_reranker:
                gaps.append(abs(r["score"] - v))
            else:
                out["blend_gap"] = max(out["blend_gap"], abs(r["score"] - v))
                y, n, _ = p["judged"][i]
                out["judge_gap"] = max(out["judge_gap"], abs(r["yes_logprob"] - y), abs(r["no_logprob"] - n))
                # a result from outside the pool the system may judge, or may draw from
                out["choice_gap"] = max(out["choice_gap"], p["t_lo"] - p["c_hi"][i], edge - v)
            out["score_gap"] = max(out["score_gap"], *gaps)

        for step, i in enumerate(idx):
            rest = [j for j in certain if j not in idx[:step]]
            if not rest:
                break
            lo = {j: self._values(p, lane, j, query)[0] for j in rest}
            if lane.diversity == 0.0 or step == 0:
                gap = max(lo.values()) - rel[step]
            else:
                cand = rest + ([i] if i not in rest else [])
                sims = dict(zip(cand, self._max_sims(cand, idx[:step])))
                obj = lambda j, v: (1 - lane.diversity) * v - lane.diversity * sims[j]  # noqa: E731
                gap = max(obj(j, lo[j]) for j in rest) - obj(i, rel[step])
            if gap > out["choice_gap"]:
                out["choice_gap"] = gap
                out["where"] = {"step": step, "served": self.c.ids[i], "best": self.c.ids[max(lo, key=lo.get)],
                                "certain": [self.c.ids[j] for j in certain[:lane.pool]],
                                "possible": len(possible)}
        return out
