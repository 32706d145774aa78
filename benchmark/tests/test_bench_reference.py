"""The plain reference and its comparison on hand-worked cases: BM25, the
hybrid top-k, the judge's blend, MMR, ties at the BM25 hit list's edge,
and the gaps of answers that differ from it."""

import math

import numpy as np
import pytest
import torch

from reference.bm25 import Bm25
from reference.models import Model
from reference.search import Corpus, Lane, Reference


def _bm25_by_hand(docs, query, k1=1.5, b=0.75):
    n = len(docs)
    avgdl = sum(len(d) for d in docs) / n
    out = []
    for d in docs:
        s = 0.0
        for t in set(query):
            df = sum(1 for x in docs if t in x)
            if not df:
                continue
            idf = max(math.log((n - df + 0.5) / (df + 0.5)), 0.0)
            tf = d.count(t)
            if tf:
                s += idf * tf * (k1 + 1) / (tf + k1 * (1 - b + b * len(d) / avgdl))
        out.append(s)
    return out


DOCS = [[0, 1, 2], [0, 0, 3, 4], [1], [5, 6, 7, 8, 9], [2, 2, 2, 6], [7]]


def _index(docs):
    offsets = np.cumsum([0] + [len(d) for d in docs])
    return Bm25(np.array([w for d in docs for w in d], dtype=np.int32), offsets, 10)


@pytest.mark.parametrize("query", [[0], [2, 6], [7, 7, 9], [4, 1], [8]])
def test_bm25_by_hand(query):
    assert np.allclose(_index(DOCS).scores(query), _bm25_by_hand(DOCS, query), rtol=1e-12)


class _Stub(Reference):
    """A reference whose judge says what it is told."""

    def __init__(self, corpus, judged=None):
        super().__init__(corpus, Model({}, {}, {}), None, None, "")
        self._yes = judged or {}

    def judge(self, query, chunks):
        out = {}
        for i in chunks:
            y = self._yes.get(int(i), 0.5)
            out[int(i)] = (math.log(y), math.log(1 - y), y)
        return out


def _corpus(rows, docs):
    rows = torch.tensor(rows, dtype=torch.float64)
    rows = (rows / rows.norm(dim=1, keepdim=True)).float()
    n = len(docs)
    return Corpus(rows=rows, bm25=_index(docs), texts=[""] * n, ids=[f"c{i}" for i in range(n)],
                  documents=[f"d{i}" for i in range(n)], pages=[1] * n)


ROWS = [[1, 0], [0.9, 0.1], [0, 1], [0.7, 0.7], [-1, 0.2], [0.5, -0.5]]
HOT = Lane(top_k=3, diversity=0.0, use_reranker=False, w_embedding=0.7, w_lexical=0.3, w_reranker=0.7,
           w_initial=0.3)


def _hand_initial(q, query_terms, limit):
    rows = torch.tensor(ROWS, dtype=torch.float64)
    e = (rows / rows.norm(dim=1, keepdim=True)).float().double() @ q
    bm = np.array(_bm25_by_hand(DOCS, query_terms))
    top = np.argsort(-bm, kind="stable")[:limit]
    lex = np.zeros(len(DOCS))
    lex[top] = bm[top] / bm.max()
    return 0.7 * e.numpy() + 0.3 * lex, e.numpy(), lex


def test_hot_answer_is_the_top_k_of_the_blend():
    ref = _Stub(_corpus(ROWS, DOCS))
    q = torch.tensor([0.6, 0.8], dtype=torch.float64)
    c, e, lex = _hand_initial(q, [2, 6], limit=15)
    got = ref.answer("", [2, 6], q, HOT)
    assert [r["chunk_id"] for r in got] == [f"c{i}" for i in np.argsort(-c, kind="stable")[:3]]
    for r in got:
        i = int(r["chunk_id"][1:])
        assert r["score"] == pytest.approx(c[i]) and r["embedding_score"] == pytest.approx(e[i])
        assert r["lexical_score"] == pytest.approx(lex[i])
    nums = ref.judge_answer("", [2, 6], q, HOT, got)
    assert nums == {"score_gap": 0.0, "judge_gap": 0.0, "choice_gap": 0.0, "short": 0.0, "where": None}


def test_gaps_of_a_wrong_answer():
    ref = _Stub(_corpus(ROWS, DOCS))
    q = torch.tensor([0.6, 0.8], dtype=torch.float64)
    c, _, _ = _hand_initial(q, [2, 6], limit=15)
    good = ref.answer("", [2, 6], q, HOT)
    swapped = [good[1], good[0], good[2]]
    order = np.sort(c)[::-1]
    assert ref.judge_answer("", [2, 6], q, HOT, swapped)["choice_gap"] == pytest.approx(order[0] - order[1])
    bent = [dict(good[0], score=good[0]["score"] + 0.01)] + good[1:]
    assert ref.judge_answer("", [2, 6], q, HOT, bent)["score_gap"] == pytest.approx(0.01)
    assert ref.judge_answer("", [2, 6], q, HOT, good[:2])["short"] == 1.0
    assert ref.judge_answer("", [2, 6], q, HOT, [dict(good[0], chunk_id="nope")])["choice_gap"] == math.inf


def test_ties_at_the_hit_lists_edge_allow_either_chunk():
    # term 9 in documents 0-5 with tf 5, 4, 3, 2, 1, 1 at equal lengths: top_k 1 allows 5 hits, and
    # documents 4 and 5 tie for the fifth; both lie along the query, the rest across it
    docs = [[9] * tf + [10 + tf] * (6 - tf) for tf in (5, 4, 3, 2, 1)] + [[9, 20, 21, 22, 23, 24]]
    docs += [[30 + i] * 6 for i in range(7)]
    rows = [[1, 0]] * 4 + [[0, 1], [0, 1]] + [[1, 0.01 * i] for i in range(7)]
    offsets = np.cumsum([0] + [len(d) for d in docs])
    ref = _Stub(_corpus(rows, docs))
    ref.c.bm25 = Bm25(np.array([w for d in docs for w in d], dtype=np.int32), offsets, 40)
    lane = Lane(top_k=1, diversity=0.0, use_reranker=False, w_embedding=0.7, w_lexical=0.3, w_reranker=0.7,
                w_initial=0.3)
    bm = ref.c.bm25.scores([9])
    assert bm[4] == bm[5] > 0 and (bm > bm[4]).sum() == 4
    q = torch.tensor([0.0, 1.0], dtype=torch.float64)
    lex = bm[4] / bm.max()
    for winner in (4, 5):
        served = [{"chunk_id": f"c{winner}", "score": 0.7 + 0.3 * lex, "embedding_score": 1.0,
                   "lexical_score": lex}]
        nums = ref.judge_answer("", [9], q, lane, served)
        assert nums["choice_gap"] < 1e-7 and nums["score_gap"] < 1e-7


def test_judged_blend_and_mmr_by_hand():
    # three candidates: 0 and 1 nearly the same row, 2 orthogonal
    rows = [[1, 0], [1, 0.02], [0, 1]]
    docs = [[1], [2], [3]]
    yes = {0: 0.9, 1: 0.8, 2: 0.3}
    ref = _Stub(_corpus(rows, docs), yes)
    lane = Lane(top_k=2, diversity=0.5, use_reranker=True, w_embedding=0.7, w_lexical=0.3, w_reranker=0.7,
                w_initial=0.3)
    q = torch.tensor([0.8, 0.6], dtype=torch.float64)
    r = ref.c.rows64
    c = (0.7 * (r @ q)).numpy()  # no lexical hits: the query term 0 is in no document
    s = 0.7 * np.array([yes[i] for i in range(3)]) / 0.9 + 0.3 * c / c.max()
    got = ref.answer("", [0], q, lane)
    first = int(np.argmax(s))
    assert got[0]["chunk_id"] == f"c{first}"
    assert got[0]["score"] == pytest.approx(s[first])
    sims = (r @ r.T).numpy()
    obj = {j: 0.5 * s[j] - 0.5 * max(0.0, sims[j, first]) for j in range(3) if j != first}
    assert got[1]["chunk_id"] == f"c{max(obj, key=obj.get)}"
    assert ref.judge_answer("", [0], q, lane, got) == {"score_gap": 0.0, "judge_gap": 0.0, "choice_gap": 0.0,
                                                       "blend_gap": 0.0, "short": 0.0, "where": None}
    no_mmr = [got[0], next(x for x in ref.answer("", [0], q, Lane(2, 0.0, True, 0.7, 0.3, 0.7, 0.3))
                           if x["chunk_id"] != got[0]["chunk_id"])]
    if no_mmr[1]["chunk_id"] != got[1]["chunk_id"]:
        assert ref.judge_answer("", [0], q, lane, no_mmr)["choice_gap"] > 0.01
    bad_judge = [dict(got[0], yes_logprob=got[0]["yes_logprob"] - 0.3)] + got[1:]
    assert ref.judge_answer("", [0], q, lane, bad_judge)["judge_gap"] == pytest.approx(0.3)
