"""The judge a configuration names: the committed judge's reference module
keeps the arithmetic of reference.models.judge and harness.work, and a
configuration naming a judge that the program does not build ends the run
with no result."""

import os

import torch

import run as bench_run
from harness import runner, work
from reference import judge_tpu_reranker, models
from reference.tokenizer import WordPieceTokenizer
from test_bench_runs import SEARCH, SEED, search_manifest

CPU = torch.device("cpu")
ASSETS = os.path.join(runner.ROOT, "rust_local_rag_tpu", "assets")
PROMPTS = ["Query: lunar tides\nDocument: the moon pulls the oceans twice a day. Answer yes or no:",
           "Query: tomato compost\n" + "Document: gardeners water the plants and add compost. " * 40 + "Answer:"]


def test_the_committed_judge_keeps_its_arithmetic():
    judge = judge_tpu_reranker.load(CPU)
    model = models.load(os.path.join(ASSETS, "reranker.safetensors"), "reranker_config", CPU)
    tok = WordPieceTokenizer(os.path.join(ASSETS, "tokenizer.json"))
    yes, no = tok.tokenize("yes"), tok.tokenize("no")
    yes_id, no_id = next((a, b) for a, b in zip(yes, no) if a != b)
    assert judge.seq_len == int(model.meta["train_seq_len"]) == 192
    ids, mask = tok.encode_batch_headtail(PROMPTS, 192)
    assert mask.sum(axis=1).tolist()[1] == 192  # the long prompt is packed head + tail
    for fp8 in (False, True):
        y, n = models.judge(model, torch.from_numpy(ids), torch.from_numpy(mask), yes_id, no_id, fp8=fp8)
        got = judge.score(PROMPTS, fp8=fp8)
        assert got == (y.double().tolist(), n.double().tolist(), mask.sum(axis=1).tolist())
    for tokens in (1, 77, 192):
        assert judge.prompt_flops(tokens, work) == work.transformer_flops(
            model.cfg, tokens, causal=True, head=int(model.cfg["vocab_size"]))


def test_a_judge_the_program_does_not_build_ends_the_run(monkeypatch, tmp_path, capsys):
    broken = tmp_path / "broken.safetensors"
    broken.write_bytes(b"no safetensors header here")
    judge = {"model": "broken-judge", "weights": str(broken), "reference": "judge_tpu_reranker"}
    manifest = search_manifest()
    real_run = runner.run

    def on_the_cpu(workload, seed, seconds, trace, t_process):
        return real_run(workload, seed, seconds, trace, t_process, device=CPU,
                        overrides={**SEARCH, "config.judge": judge})

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(runner, "read_manifest", lambda bench_dir=runner.BENCH_DIR: manifest)
    monkeypatch.setattr(runner, "run", on_the_cpu)
    code = bench_run.main(["--workload", "covid-default", "--seed", str(SEED), "--seconds", "4", "--trace", "0"])
    out, err = capsys.readouterr()
    assert code == 1
    assert not [line for line in out.splitlines() if line.startswith("{")]
    assert "the program built none" in err
