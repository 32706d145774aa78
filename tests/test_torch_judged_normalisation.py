"""The judged lane's normalisation, score = init_w * initial / vmax (vmax the
query's largest live initial score), in the port's fetch_judged and the JAX
package's, on the same [Q, k] columnar planes.

A query far from the corpus has a small vmax (0.028 for the off-corpus
query of tests/test_torch_http.py), so any difference in the initial-score
plane reaches score multiplied by init_w / vmax. These tests pin that: the
same planes give a bit-identical score in both packages (the division
agrees; tolerance 0), and one ulp more in one initial score moves its score
by init_w / vmax of that ulp (to within one ulp of the score's own
rounding). What the HTTP parity test sees across servers is therefore the
dense plane's last-bit summation-order difference, amplified: ROADMAP C10.
"""

from types import SimpleNamespace

import numpy as np
import pytest

from rust_local_rag_tpu.engine.rag_engine import ColumnarResults as JColumnar
from rust_local_rag_tpu.engine.rag_engine import PendingJudged as JPending
from rust_local_rag_tpu.engine.rag_engine import RagEngine as JEngine
from rust_local_rag_tpu_torch.engine.rag_engine import ColumnarResults as TColumnar
from rust_local_rag_tpu_torch.engine.rag_engine import PendingJudged as TPending
from rust_local_rag_tpu_torch.engine.rag_engine import RagEngine as TEngine

Q, K = 4, 12
VMAX = np.float32(0.0282309)      # the off-corpus query's largest initial score
INITIAL = np.float32(-0.0732628)  # the row whose score differed across servers


def planes(rng):
    """[Q, K] columnar planes sorted descending along k, vals' row max VMAX
    (row 0 holds the HTTP case), a freed slot in row 2, judge outputs for
    every live row as the reranker's (yes-p, yes logprob, no logprob)."""
    vals = np.sort(rng.uniform(-0.09, 0.02, (Q, K)).astype(np.float32), axis=1)[:, ::-1].copy()
    vals[:, 0] = VMAX
    vals[0, 5] = INITIAL
    vals = np.sort(vals, axis=1)[:, ::-1].copy()
    emb = rng.uniform(-0.2, 0.3, (Q, K)).astype(np.float32)
    lex = rng.uniform(0.0, 1.0, (Q, K)).astype(np.float32)
    slots = np.arange(Q * K, dtype=np.int32).reshape(Q, K)
    slots[2, 7] = -1
    qi, rank = np.nonzero(slots >= 0)
    logp = rng.uniform(-6.0, -0.01, (qi.size, 2))
    scored = [(float(np.exp(y)), float(y), float(n)) for y, n in logp]
    return vals, emb, lex, slots, qi, rank, scored


def judged_score(engine_cls, columnar_cls, pending_cls, vals, emb, lex, slots, qi, rank, scored, **kw):
    """fetch_judged of engine_cls on the given planes; the engine's only
    state it reads is its reranker's fetch_prompts, stubbed to `scored`."""
    extra = {"store": None} if columnar_cls is JColumnar else {}
    col = columnar_cls(vals=vals.copy(), emb=emb, lex=lex, slots=slots.copy(), floor=0.0, **extra)
    pj = pending_cls(col=col, handle=None, flat_qi=qi, flat_rank=rank, nq=Q, thr=0.0, cos_floor=0.0,
                     q_floor=0.0, init_w=1.0, **kw)
    stub = SimpleNamespace(reranker=SimpleNamespace(fetch_prompts=lambda handle: scored))
    return engine_cls.fetch_judged(stub, pj).score


def both(vals, *rest, **kw):
    return (judged_score(TEngine, TColumnar, TPending, vals, *rest, **kw),
            judged_score(JEngine, JColumnar, JPending, vals, *rest, **kw))


@pytest.mark.parametrize("gate", [False, True], ids=["no_gate", "unseen_gate"])
def test_judged_normalisation_is_bit_identical(rng, gate):
    vals, emb, lex, slots, qi, rank, scored = planes(rng)
    kw = {}
    if gate:  # the shipped unseen gate (baseline.yaml:58-65), firing on query 3 only
        kw = {"unseen": np.array([0.0, 0.1, 0.2, 0.9], np.float32), "unseen_mass": 0.35,
              "unseen_cos": 0.6, "unseen_judge": 1.0}
    port, ref = both(vals, emb, lex, slots, qi, rank, scored, **kw)
    assert port.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(port, ref)  # tolerance 0: bit-identical
    r = int(np.nonzero(vals[0] == INITIAL)[0][0])
    assert port[0, r] == np.float32(np.float32(1.0) * INITIAL / VMAX)
    assert abs(port[0, r] / INITIAL) > 30  # the HTTP case's amplification, 1 / 0.028


def test_one_ulp_of_initial_moves_score_by_one_over_vmax(rng):
    vals, emb, lex, slots, qi, rank, scored = planes(rng)
    r = int(np.nonzero(vals[0] == INITIAL)[0][0])
    port, ref = both(vals, emb, lex, slots, qi, rank, scored)
    bumped = vals.copy()
    bumped[0, r] = np.nextafter(INITIAL, np.float32(0.0))  # one ulp toward 0, not the row max
    ulp = float(bumped[0, r]) - float(INITIAL)
    port2, ref2 = both(bumped, emb, lex, slots, qi, rank, scored)
    np.testing.assert_array_equal(port2, ref2)
    moved = port2 != port
    assert moved[0, r] and moved.sum() == 1  # only that score moves; vmax is unchanged
    shift = float(port2[0, r]) - float(port[0, r])
    # init_w / vmax of the ulp, to within one ulp of the score's own rounding
    assert abs(shift - ulp / float(VMAX)) <= float(np.spacing(np.abs(port[0, r])))
    assert abs(shift) / abs(ulp) > 30
