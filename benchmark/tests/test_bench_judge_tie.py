"""The judge's logit tie (a configuration's ties["judge_logit"]) in the
comparison of a judged answer, by hand: a choice between two chunks whose
yes logits over no lie within the tie is right either way, one beyond it
is not, and a served blended score is held to the range the tie allows:
inside it blend_gap reads 0, outside it the distance beyond."""

import math

import pytest
import torch

from reference.search import Lane
from test_bench_reference import _corpus, _Stub

# three chunks along the same row, so their first-stage scores are equal and only the judge orders them
YES = {0: 0.81, 1: 0.80, 2: 0.30}
JUDGED = Lane(top_k=1, diversity=0.0, use_reranker=True, w_embedding=0.7, w_lexical=0.3, w_reranker=0.7,
              w_initial=0.3)


def _logit(y):
    return math.log(y / (1 - y))


def _served(ref, i, q):
    """Chunk i served alone, its values as the reference computes them."""
    best = next(r for r in ref.answer("", [0], q, JUDGED))
    s = JUDGED.w_reranker * YES[i] / YES[int(best["chunk_id"][1:])] + JUDGED.w_initial
    return [dict(best, chunk_id=f"c{i}", score=s, reranker_score=YES[i], yes_logprob=math.log(YES[i]),
                 no_logprob=math.log(1 - YES[i]))]


@pytest.mark.parametrize("tie", [0.0, 0.1])
def test_choices_within_the_judges_tie_are_right(tie):
    ref = _Stub(_corpus([[1, 0]] * 3, [[1], [2], [3]]), YES)
    ref.logit_tie = tie  # as Reference(..., ties={"judge_logit": tie}) sets it
    q = torch.tensor([1.0, 0.0], dtype=torch.float64)
    assert ref.answer("", [0], q, JUDGED)[0]["chunk_id"] == "c0"
    assert ref.judge_answer("", [0], q, JUDGED, _served(ref, 0, q))["choice_gap"] == 0.0
    assert _logit(YES[0]) - _logit(YES[1]) < 2 * 0.1 < _logit(YES[0]) - _logit(YES[2])
    near = ref.judge_answer("", [0], q, JUDGED, _served(ref, 1, q))
    far = ref.judge_answer("", [0], q, JUDGED, _served(ref, 2, q))
    assert (near["choice_gap"] == 0.0) is (tie > 0), near
    assert far["choice_gap"] > 0.1, far
    assert near["score_gap"] < 1e-9 and far["score_gap"] < 1e-9
    assert near["blend_gap"] < 1e-9 and far["blend_gap"] < 1e-9
    for i in (0, 2):
        top = max(ref._values(ref._plan("", [0], q, JUDGED, tie=True), JUDGED, i, ""))
        for shift in (0.01, 0.5):
            bent = _served(ref, i, q)
            bent[0]["score"] = top + shift
            nums = ref.judge_answer("", [0], q, JUDGED, bent)
            assert nums["blend_gap"] == pytest.approx(shift) and nums["score_gap"] < 1e-9, (i, shift, nums)
