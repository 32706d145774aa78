"""Yes/no reranker training (port of rust_local_rag_tpu/training/train_reranker.py).

Teaches the causal decoder (models/reranker.py) to answer the serving
prompt (reranker_service.DEFAULT_PROMPT_TEMPLATE, the same template at
training and serving) with "yes" for a (query, passage) pair mined from
the same paragraph and "no" for a mismatched one. The loss combines a
pairwise logistic term on the yes/no margin difference of the positive
and the mined negative (ordering) with binary cross-entropy on each
margin (calibration: the serving rejection floor reads the absolute
yes-probability).

Negatives are BM25-mined keyword traps (the serving pool is full of
them); dense-mined negatives, RocketQA-denoised or not, lost end to end
in every recorded run of the JAX package's trainer, whose docstring keeps
the lessons behind each default below (junk pairs retrieved, not random;
document-derived junk, which cannot be memorised; randomised prompt
fields).

Run on the card:
    python -m rust_local_rag_tpu_torch.training.train_reranker \
        --corpus .cache/train_corpus.txt \
        --tokenizer rust_local_rag_tpu/assets/tokenizer.json --out /tmp/rr/reranker.safetensors

The tokenizer defaults to tokenizer.json beside --out, so a run whose
--out lies elsewhere than the committed assets must pass --tokenizer.
--device cpu runs on the CPU (the tests do); the default is the card.
The reranker trains on one device, as the JAX trainer does (jax.jit
without a mesh).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from rust_local_rag_tpu_torch.training.mining import mine_dense_neighbors


def _default_out() -> str:
    from rust_local_rag_tpu_torch.models.encoder import default_asset

    return default_asset("reranker.safetensors")


class PromptPairBatcher:
    """(positive prompt, mined-negative prompt) pair batches."""

    def __init__(
        self,
        paragraphs: List[str],
        tokenizer,
        template: str,
        seq_len: int = 192,
        seed: int = 0,
        index_size: int = 50000,
        random_negative_frac: float = 0.2,
        dense_neighbors: Optional[np.ndarray] = None,
        ood_frac: float = 0.0,
        junk_hard_frac: float = 0.5,
        paraphrase_frac: float = 0.0,
        junk_pool: Optional[List[str]] = None,
        device="cuda",
    ):
        """`tokenizer`: the port's WordPiece tokenizer (token_to_id,
        encode_batch_headtail). `device` mines the junk queries' dense
        neighbors (ood_frac > 0 with junk_hard_frac > 0)."""
        self.rng = np.random.default_rng(seed)
        self.seq_len = seq_len
        self._doc_pool: List[str] = []
        self.tk = tokenizer
        self.cls_id = self.tk.token_to_id("[CLS]")
        self.sep_id = self.tk.token_to_id("[SEP]")
        self.pad_id = self.tk.token_to_id("[PAD]")
        self.random_frac = random_negative_frac
        self.paragraphs = [p for p in paragraphs if len(p.split()) >= 16]
        self.template = template
        # BM25 index over a corpus sample for serving-pool-like negatives.
        # Live per-example scoring is far too slow (a Python BM25 query is
        # ~60 ms; 6k steps x 256 pairs would take >24 h of host time), so
        # neighbors are PRE-MINED here once: each paragraph gets the top
        # lexical hits for a canonical query crop drawn from the same
        # distribution the trainer samples live. The live crop differs from
        # the mining crop, but the neighbor is still the keyword-trap case —
        # crops share the paragraph's vocabulary.
        sample = self.rng.permutation(len(self.paragraphs))[:index_size]
        self.indexed = [int(i) for i in sample]
        self.neighbors = self._premine()
        # optional second neighbor table mined by the TRAINED dense
        # encoder (v3 recipe): dense near-misses are the failure mode the
        # hybrid first stage actually surfaces — semantically adjacent
        # paragraphs BM25 would rank low. Rows align with `paragraphs`
        # (filtered), -1 padded.
        self.dense_neighbors = dense_neighbors
        # far-out-of-domain junk queries as "no" supervision (training/
        # ood.py): calibrates the absolute yes-probability the engine's
        # rejection_threshold gates on
        self.ood_frac = ood_frac
        self.junk_hard_frac = junk_hard_frac
        self._junk: List[str] = []
        self._junk_neighbors = None
        if ood_frac > 0:
            if junk_pool is not None:
                # caller-assembled mix (template banks + document-derived
                # junk, --junk-doc-frac)
                self._junk = list(junk_pool)
            else:
                from rust_local_rag_tpu_torch.training.ood import junk_queries

                self._junk = junk_queries(4096, seed=seed)
            if junk_hard_frac > 0:
                # v11 recipe: a junk "no" pair must look like what the
                # serving gate actually scores — the junk query's TOP
                # RETRIEVED passages, not a random one (mining.py
                # mine_junk_neighbors rationale). Mined over the same
                # indexed pool the BM25 negative premine uses.
                from rust_local_rag_tpu_torch.training.mining import mine_junk_neighbors

                # Mine as WIDE as the serving exposure: the gate scores
                # the junk query against every candidate in the retrieved
                # head, and the v12 diagnostic showed the leak lives in
                # the mid-tail — training only on the top-4 neighbors left
                # ranks 5-15 unseen (per-query max yes-p over 15 mined
                # candidates read ~0.7 while the trained top pairs read
                # ~0.02). 7 BM25 + 8 dense ≈ one serving head.
                self._junk_neighbors = mine_junk_neighbors(
                    self._junk, self.paragraphs, pool=self.indexed,
                    n_bm25=7, n_dense=8, device=device,
                )
        # paraphrase the POSITIVE query with this probability so the judge
        # stops keying on verbatim overlap (VERDICT r2 missing #3: crop
        # queries != paraphrase serving queries; the v7/v8 judges lost at
        # every blend weight > 0 because of exactly this gap)
        self.paraphrase_frac = paraphrase_frac

    def _premine(self, n_neighbors: int = 4, threads: int = 8):
        """[P, n_neighbors] int32 neighbor table; -1 = no mined hit.

        Threaded, each worker on its own index over self.indexed
        (pairs.bm25_neighbors).
        """
        import hashlib

        from rust_local_rag_tpu_torch.training.pairs import bm25_neighbors

        # ~25 min of single-core host time at 180k paragraphs: cache the
        # table on disk keyed by (corpus, params, rng position) — the rng
        # state at entry covers both the seed and the index-sample draw
        # (same recipe as training/pairs.py premine_hard_negatives); the
        # "torch" prefix keeps the port's tables apart from the JAX package's
        h = hashlib.sha256()
        h.update(f"torch|rr|{n_neighbors}|".encode())
        h.update(str(self.rng.bit_generator.state).encode())
        for t in self.paragraphs:
            h.update(t.encode())
            h.update(b"\0")
        cache = os.path.join(
            os.path.expanduser("~"), ".cache", "rag_tpu_premine",
            "torch_" + h.hexdigest()[:24] + ".npy",
        )
        if os.path.exists(cache):
            self.rng.integers(2**31)  # keep the rng stream identical
            print(f"premine cache hit: {cache}")
            return np.load(cache)

        crop_rng = np.random.default_rng(self.rng.integers(2**31))
        crops = []
        for p in self.paragraphs:
            words = p.split()
            qlen = int(crop_rng.integers(3, 13))
            start = int(crop_rng.integers(0, max(len(words) - qlen, 1)))
            crops.append(" ".join(words[start : start + qlen]))

        t0 = time.monotonic()
        out = bm25_neighbors(self.paragraphs, self.indexed, crops, n_neighbors, threads)
        n = len(self.paragraphs)
        print(
            f"pre-mined {n} paragraphs x {n_neighbors} BM25 negatives "
            f"in {time.monotonic() - t0:.1f}s"
        )
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        tmp = cache + ".tmp"
        with open(tmp, "wb") as f:
            np.save(f, out)
        os.replace(tmp, cache)
        return out

    def _query_and_passage(self, para: str) -> Tuple[str, str]:
        words = para.split()
        qlen = int(self.rng.integers(3, 13))
        start = int(self.rng.integers(0, max(len(words) - qlen, 1)))
        q = " ".join(words[start : start + qlen])
        paraphrased = (
            self.paraphrase_frac > 0
            and self.rng.random() < self.paraphrase_frac
        )
        if paraphrased:
            from rust_local_rag_tpu_torch.training.paraphrase import paraphrase

            q = paraphrase(q, self.rng)
        if paraphrased or self.rng.random() < 0.2:
            # paraphrased queries keep the FULL passage: span removal
            # exists to defeat copy-matching, which the rewrite already
            # breaks — and the serving passage always contains its answer
            passage = para
        else:
            passage = " ".join(words[:start] + words[start + qlen :])
        return q, passage

    def _mined_negative(self, query: str, avoid: int) -> str:
        """Pre-mined BM25 neighbor of the source paragraph — the
        lexically-attractive wrong answer the reranker must demote."""
        n = len(self.paragraphs)
        if self.rng.random() > self.random_frac:
            row = self.neighbors[avoid]
            if (
                self.dense_neighbors is not None
                and self.rng.random() < 0.5
            ):
                row = self.dense_neighbors[avoid]
            cands = row[(row >= 0) & (row != avoid)]
            if cands.size:
                return self.paragraphs[
                    int(cands[int(self.rng.integers(0, cands.size))])
                ]
        j = int(self.rng.integers(0, n))
        if j == avoid:
            j = (j + 1) % n
        return self.paragraphs[j]

    def _prompt(self, q: str, text: str) -> str:
        """Field-RANDOMIZED prompt: serving fills {document}/{page} with the
        real file name and page (reranker_service.build_prompt), and the r4
        diagnosis showed a judge trained on constant fields keys on the
        unfamiliar names — junk max yes-p on the dev corpus read mean 0.56
        with real fields vs 0.28 with the training constants. Randomizing
        the fields trains the judge to be invariant to them, so relevance
        comes from the query/text pair alone."""
        if not self._doc_pool:
            words = sorted(
                {
                    w
                    for p in self.paragraphs[:2000]
                    for w in p.lower().split()
                    if 4 <= len(w) <= 12 and w.isalpha()
                }
            )
            pool_rng = np.random.default_rng(12345)
            self._doc_pool = [
                f"{words[int(pool_rng.integers(0, len(words)))]}_"
                f"{words[int(pool_rng.integers(0, len(words)))]}.pdf"
                for _ in range(256)
            ] or ["corpus.pdf"]
        doc = self._doc_pool[int(self.rng.integers(0, len(self._doc_pool)))]
        # serving maps page_number 0 -> "unknown"; train on both forms
        page = (
            "unknown"
            if self.rng.random() < 0.1
            else str(int(self.rng.integers(1, 40)))
        )
        return self.template.format(
            query=q, document=doc, page=page, section="N/A", text=text
        )

    def _encode(self, prompts: List[str]):
        # keep the prompt TAIL when truncating: the yes/no question and
        # "Answer:" cue must stay at the end. Shared with the serving
        # encoder (models/tokenizer.headtail_pack) so train and serve can
        # never drift again — the r4 rejection leak was exactly that drift.
        return self.tk.encode_batch_headtail(prompts, self.seq_len)

    def batch(self, batch_size: int):
        """-> (pos_ids, pos_mask, neg_ids, neg_mask), each [B, L]: the SAME
        query against its source passage and a mined negative."""
        pos_prompts, neg_prompts = [], []
        n = len(self.paragraphs)
        for _ in range(batch_size):
            i = int(self.rng.integers(0, n))
            q, passage = self._query_and_passage(self.paragraphs[i])
            pos_prompts.append(self._prompt(q, passage))
            if self._junk and self.rng.random() < self.ood_frac:
                # junk query against ANY corpus passage is a "no": the
                # pairwise term still orders pos(q+) above it, and the BCE
                # term drives the absolute yes-probability toward 0 —
                # which is what the engine's rejection floor reads
                jqi = int(self.rng.integers(0, len(self._junk)))
                jq = self._junk[jqi]
                j = int(self.rng.integers(0, n))
                if (
                    self._junk_neighbors is not None
                    and self.rng.random() < self.junk_hard_frac
                ):
                    # HARD junk pair: the passage retrieval would surface
                    # for this junk query (BM25 + dense mined) — the pair
                    # the serving rejection floor actually scores
                    row = self._junk_neighbors[jqi]
                    cands = row[row >= 0]
                    if cands.size:
                        j = int(cands[int(self.rng.integers(0, cands.size))])
                neg_prompts.append(self._prompt(jq, self.paragraphs[j]))
            else:
                neg_prompts.append(
                    self._prompt(q, self._mined_negative(q, i))
                )
        pi, pm = self._encode(pos_prompts)
        ni, nm = self._encode(neg_prompts)
        return pi, pm, ni, nm

    def stacked(self, n_steps: int, batch_size: int):
        cols = [[], [], [], []]
        for _ in range(n_steps):
            for c, arr in zip(cols, self.batch(batch_size)):
                c.append(arr)
        return tuple(np.stack(c) for c in cols)


def _doc_junk_queries(pars: List[str], n: int, seed: int) -> List[str]:
    """Junk queries synthesized from junk-holdout package prose: the same
    crop distribution the positive queries use (3-13 word spans), half of
    them paraphrase/question-framed — so the ONLY difference between a
    junk query and a gold query is whether the corpus can answer it, not
    style. Style-distinguishable junk is what the template banks gave the
    judge, and the judge learned the style instead of the relation."""
    from rust_local_rag_tpu_torch.training.paraphrase import paraphrase

    rng = np.random.default_rng(seed)
    out: List[str] = []
    while len(out) < n and pars:
        p = pars[int(rng.integers(0, len(pars)))]
        words = p.split()
        qlen = int(rng.integers(3, 13))
        start = int(rng.integers(0, max(len(words) - qlen, 1)))
        q = " ".join(words[start : start + qlen])
        if rng.random() < 0.5:
            q = paraphrase(q, rng)
        out.append(q)
    return out


def margins(model, ids: torch.Tensor, mask: torch.Tensor, yes_id: int, no_id: int) -> torch.Tensor:
    """[B] yes - no logit margins at each row's last valid position (the
    plain, differentiable attention path)."""
    logits = model.forward_last_logits(ids, mask, fused_attn=False)
    return logits[:, yes_id] - logits[:, no_id]


def pair_loss(model, pi, pm, ni, nm, yes_id: int, no_id: int) -> torch.Tensor:
    """mean(-log sigmoid(m+ - m-)) + 0.5 mean(-log sigmoid(m+) - log sigmoid(-m-))."""
    mp = margins(model, pi, pm, yes_id, no_id)
    mn = margins(model, ni, nm, yes_id, no_id)
    pairwise = -torch.nn.functional.logsigmoid(mp - mn)  # ordering
    cal = -torch.nn.functional.logsigmoid(mp) - torch.nn.functional.logsigmoid(-mn)  # calibration
    return pairwise.mean() + 0.5 * cal.mean()


def decision_ids(tokenizer, cls_id: int, sep_id: int) -> Tuple[int, int]:
    """The first content wordpiece of "yes" and of "no" (serving's rule)."""
    def content(word):
        return [i for i in tokenizer.tokenize(word) if i not in (cls_id, sep_id)]

    return content("yes")[0], content("no")[0]


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--corpus", help="pre-harvested paragraph file")
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--scan", type=int, default=16)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--warmup", type=int, default=400)
    ap.add_argument("--seq-len", type=int, default=192)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--dim", type=int, default=384)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--heads", type=int, default=6)
    ap.add_argument("--ffn", type=int, default=1024)
    ap.add_argument("--out", default=_default_out())
    ap.add_argument("--tokenizer", default=None, help="default: tokenizer.json beside --out")
    ap.add_argument("--eval-every", type=int, default=1600)
    ap.add_argument("--no-exclude-eval", action="store_true")
    ap.add_argument(
        "--dense-negatives", choices=("auto", "on", "off"), default="off",
        help="mine negatives with the committed dense encoder too; "
        "auto = when the encoder asset exists. Off by default: the v3 "
        "run with dense negatives LOST end-to-end",
    )
    ap.add_argument(
        "--no-denoise", action="store_true",
        help="skip the RocketQA reranker-denoise pass over dense-mined "
        "negatives (mining.cached_denoised_table)",
    )
    ap.add_argument(
        "--dense-margin", type=float, default=0.0,
        help="yes/no logit margin above which the committed judge calls "
        "a mined neighbor a false negative and drops it",
    )
    ap.add_argument(
        "--ood-frac", type=float, default=0.0,
        help="fraction of negative prompts whose query is a synthesized "
        "far-out-of-domain factoid (training/ood.py) — calibrates the "
        "absolute yes-probability for the engine's rejection floor",
    )
    ap.add_argument(
        "--junk-hard-frac", type=float, default=0.5,
        help="within the --ood-frac junk draws, fraction paired with the "
        "junk query's own RETRIEVED passages (BM25+dense mined, "
        "mining.mine_junk_neighbors) instead of a random one",
    )
    ap.add_argument(
        "--junk-doc-frac", type=float, default=0.5,
        help="within the --ood-frac junk pool, fraction of junk queries "
        "synthesized as crop/paraphrase queries from JUNK_HOLDOUT_PACKAGES "
        "prose (training/corpus.py); 0 restores template-only junk",
    )
    ap.add_argument(
        "--readme-corpus", type=int, default=1,
        help="1 (default) mixes wheel-README prose (corpus.harvest_readmes) "
        "into the training corpus; 0 restores the docstring-only corpus",
    )
    ap.add_argument(
        "--paraphrase-frac", type=float, default=0.0,
        help="fraction of positive queries rewritten by "
        "training/paraphrase.py (synonym substitution + question framing)",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from rust_local_rag_tpu_torch.device import resolve_device
    from rust_local_rag_tpu_torch.models.checkpoint import flatten_params, load_params, save_params
    from rust_local_rag_tpu_torch.models.reranker import Reranker, RerankerConfig
    from rust_local_rag_tpu_torch.models.reranker_service import DEFAULT_PROMPT_TEMPLATE
    from rust_local_rag_tpu_torch.parallel.train import make_optimizer
    from rust_local_rag_tpu_torch.training.corpus import harvest
    from rust_local_rag_tpu_torch.training.train_encoder import (
        DispatchLog,
        load_training_paragraphs,
        split_holdout,
        training_tokenizer,
    )

    device = resolve_device(args.device)
    tok_path = args.tokenizer or os.path.join(os.path.dirname(args.out), "tokenizer.json")
    tokenizer = training_tokenizer(tok_path)

    paragraphs, exclude = load_training_paragraphs(args.corpus, not args.no_exclude_eval)
    if args.readme_corpus:
        from rust_local_rag_tpu_torch.training.corpus import harvest_readmes, normalized_hash

        readmes = harvest_readmes(
            exclude_hashes=exclude,
            already_seen={normalized_hash(p) for p in paragraphs},
        )
        print(f"+{len(readmes)} readme (authored-style) paragraphs")
        paragraphs = paragraphs + readmes
    print(f"{len(paragraphs)} paragraphs")

    train_pars, held_pars = split_holdout(paragraphs, args.seed, 2048)

    dense = None
    if args.dense_negatives != "off":
        filtered = [p for p in train_pars if len(p.split()) >= 16]
        if args.no_denoise:
            dense = mine_dense_neighbors(filtered, device=device)
        else:
            from rust_local_rag_tpu_torch.training.mining import cached_denoised_table

            try:
                dense, _ = cached_denoised_table(filtered, margin=args.dense_margin, device=device)
            except RuntimeError as e:
                # auto mode degrades to BM25-only when assets are missing
                if args.dense_negatives == "on":
                    raise SystemExit(str(e))
                print(f"dense negatives unavailable: {e}")
        if dense is None and args.dense_negatives == "on":
            raise SystemExit("--dense-negatives=on but no encoder asset")

    junk_pool = None
    doc_junk_probe_pars: Optional[List[str]] = None
    if args.ood_frac > 0 and args.junk_doc_frac > 0:
        from rust_local_rag_tpu_torch.training.corpus import JUNK_HOLDOUT_PACKAGES, normalized_hash
        from rust_local_rag_tpu_torch.training.ood import junk_queries

        jpars = harvest(
            packages=list(JUNK_HOLDOUT_PACKAGES),
            exclude_hashes=exclude,
            max_paragraphs=24000,
        )
        train_hashes = {normalized_hash(p) for p in paragraphs}
        jpars = [
            p
            for p in jpars
            if normalized_hash(p) not in train_hashes
            and len(p.split()) >= 16
        ]
        jrng = np.random.default_rng(args.seed + 777)
        jorder = jrng.permutation(len(jpars))
        probe_n = min(512, len(jpars) // 10)
        doc_junk_probe_pars = [jpars[i] for i in jorder[:probe_n]]
        doc_src = [jpars[i] for i in jorder[probe_n:]]
        n_doc = int(4096 * args.junk_doc_frac)
        doc_junk = _doc_junk_queries(doc_src, n_doc, args.seed + 778)
        junk_pool = junk_queries(4096 - n_doc, seed=args.seed) + doc_junk
        print(
            f"doc-junk: {len(doc_src)} holdout paragraphs -> {n_doc} "
            f"train junk queries + {probe_n} probe paragraphs "
            f"({4096 - n_doc} template junk)"
        )

    batcher = PromptPairBatcher(
        train_pars, tokenizer, DEFAULT_PROMPT_TEMPLATE,
        seq_len=args.seq_len, seed=args.seed, dense_neighbors=dense,
        ood_frac=args.ood_frac, junk_hard_frac=args.junk_hard_frac,
        paraphrase_frac=args.paraphrase_frac,
        junk_pool=junk_pool, device=device,
    )
    if dense is not None and len(batcher.paragraphs) != dense.shape[0]:
        # the dense table was mined over the SAME >=16-word filter the
        # batcher applies: rows must align 1:1
        raise AssertionError(f"dense table {dense.shape} for {len(batcher.paragraphs)} paragraphs")
    held = PromptPairBatcher(
        held_pars, tokenizer, DEFAULT_PROMPT_TEMPLATE,
        seq_len=args.seq_len, seed=args.seed + 1, index_size=10000,
    )
    eval_pi, eval_pm, eval_ni, eval_nm = held.batch(512)
    # paraphrase probe: the SAME held paragraphs but with every positive
    # query rewritten (paraphrase.py) — the serving-register question the
    # verbatim pair-acc metric cannot see
    held_para = PromptPairBatcher(
        held_pars, tokenizer, DEFAULT_PROMPT_TEMPLATE,
        seq_len=args.seq_len, seed=args.seed + 2, index_size=10000,
        paraphrase_frac=1.0,
    )
    para_pi, para_pm, para_ni, para_nm = held_para.batch(512)
    # OOD rejection probes (templates reserved out of training, random and
    # retrieved held passages) and the doc-junk probe: each query's MAX
    # yes-probability over its retrieved head is what the serving gate reads
    ood_ids = ood_mask = None
    probes = {}
    if args.ood_frac > 0:
        from rust_local_rag_tpu_torch.training.mining import mine_junk_neighbors
        from rust_local_rag_tpu_torch.training.ood import junk_queries

        jrng = np.random.default_rng(999)
        jqs = junk_queries(256, seed=7, split="probe")
        ood_prompts = [
            held._prompt(jq, held.paragraphs[
                int(jrng.integers(0, len(held.paragraphs)))
            ])
            for jq in jqs
        ]
        ood_ids, ood_mask = held._encode(ood_prompts)
        jtab = mine_junk_neighbors(jqs, held.paragraphs, n_bm25=7, n_dense=8, device=device)
        probes["ood-hard"] = _probe_prompts(held, jqs, jtab)
    if doc_junk_probe_pars:
        from rust_local_rag_tpu_torch.training.mining import mine_junk_neighbors

        djq = _doc_junk_queries(doc_junk_probe_pars, 192, seed=9991)
        jtab2 = mine_junk_neighbors(djq, held.paragraphs, n_bm25=7, n_dense=8, device=device)
        probes["doc-junk"] = _probe_prompts(held, djq, jtab2)
    probes = {k: v for k, v in probes.items() if v is not None}

    cfg = RerankerConfig(
        vocab_size=tokenizer.vocab_size,
        dim=args.dim,
        depth=args.depth,
        heads=args.heads,
        ffn_dim=args.ffn,
    )
    model = Reranker(cfg, torch.Generator().manual_seed(args.seed)).to(device)
    leaves = list(model.parameters())

    # yes/no target ids: first differing wordpiece (same rule as serving)
    yes_id, no_id = decision_ids(tokenizer, batcher.cls_id, batcher.sep_id)
    print(f"yes_id={yes_id} no_id={no_id}")

    tx = make_optimizer(args.lr, args.warmup, args.steps, 0.01)
    opt_state = tx.init(leaves)

    def dev(x) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    def _yes_p_sliced(model, ids, mask, bs: int = 512) -> np.ndarray:
        """yes-probabilities for a large prompt set in fixed-size slices (a
        single 3.8k x 192 forward would allocate a multi-GB attention
        tensor)."""
        n = ids.shape[0]
        out = np.zeros(n, dtype=np.float32)
        with torch.no_grad():
            for lo in range(0, n, bs):
                hi = min(lo + bs, n)
                i = np.zeros((bs, ids.shape[1]), dtype=ids.dtype)
                m = np.zeros((bs, mask.shape[1]), dtype=mask.dtype)
                i[: hi - lo] = ids[lo:hi]
                m[: hi - lo] = mask[lo:hi]
                m[hi - lo :, 0] = 1  # keep padded rows finite
                yp = torch.sigmoid(margins(model, dev(i), dev(m), yes_id, no_id))
                out[lo:hi] = yp.cpu().numpy()[: hi - lo]
        return out

    def eval_metrics(model, pi, pm, ni, nm):
        with torch.no_grad():
            mp = margins(model, dev(pi), dev(pm), yes_id, no_id)
            mn = margins(model, dev(ni), dev(nm), yes_id, no_id)
        pair_acc = float((mp > mn).float().mean())
        cls_acc = 0.5 * (float((mp > 0).float().mean()) + float((mn < 0).float().mean()))
        return pair_acc, cls_acc

    def probe_notes(model) -> Tuple[str, dict]:
        note, means = "", {}
        if ood_ids is not None:
            yes_p = _yes_p_sliced(model, ood_ids, ood_mask)
            note = f" ood yes-p mean {float(yes_p.mean()):.3f} max {float(yes_p.max()):.3f}"
        for name, (ids, mask, qid) in probes.items():
            yp = _yes_p_sliced(model, ids, mask)
            # serving-relevant statistic: the gate sees the MAX yes-p over
            # each junk query's retrieved head
            qmax = np.zeros(int(qid.max()) + 1, dtype=np.float32)
            np.maximum.at(qmax, qid, yp)
            means[name] = float(qmax.mean())
            note += (f" {name} qmax mean {means[name]:.3f} "
                     f"med {float(np.median(qmax)):.3f} max {float(qmax.max()):.3f}")
        return note, means

    pa, ca = eval_metrics(model, eval_pi, eval_pm, eval_ni, eval_nm)
    ppa, pca = eval_metrics(model, para_pi, para_pm, para_ni, para_nm)
    print(
        f"step 0: held-out pair acc {pa:.3f} cls acc {ca:.3f} "
        f"| paraphrase pair acc {ppa:.3f} cls {pca:.3f}"
    )

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    log = DispatchLog(args.batch)
    best_acc = -1.0
    best_params = None
    best_step = 0
    done = 0
    while done < args.steps:
        s = min(args.scan, args.steps - done)
        t_host = time.perf_counter()
        pi, pm, ni, nm = batcher.stacked(s, args.batch)
        if s < args.scan:
            reps = args.scan - s
            pi, pm, ni, nm = (
                np.concatenate([x, x[-1:].repeat(reps, 0)])
                for x in (pi, pm, ni, nm)
            )
        t_dev = time.perf_counter()
        stacks = [dev(x) for x in (pi, pm, ni, nm)]
        losses = []
        for k in range(args.scan):
            model.zero_grad(set_to_none=True)
            loss = pair_loss(model, *(x[k] for x in stacks), yes_id, no_id)
            loss.backward()
            opt_state = tx.step(leaves, opt_state)
            losses.append(loss.detach())
        model.zero_grad(set_to_none=True)
        loss = float(torch.stack(losses).mean())  # waits for the device
        log.add(args.scan, t_dev - t_host, time.perf_counter() - t_dev, loss)
        done += args.scan
        if done % max(args.scan * 4, 64) == 0 or done >= args.steps:
            dt = time.monotonic() - log.t0
            print(
                f"step {done}/{args.steps} loss {loss:.4f} "
                f"({done / dt:.1f} steps/s)",
                flush=True,
            )
        if args.eval_every and (
            # fire on CROSSING each eval_every boundary: done advances in
            # --scan increments
            done // args.eval_every > (done - args.scan) // args.eval_every
            or done >= args.steps
        ):
            pa, ca = eval_metrics(model, eval_pi, eval_pm, eval_ni, eval_nm)
            ppa, pca = eval_metrics(model, para_pi, para_pm, para_ni, para_nm)
            ood_note, means = probe_notes(model)
            print(
                f"step {done}: held-out pair acc {pa:.3f} "
                f"cls acc {ca:.3f} | paraphrase pair "
                f"{ppa:.3f} cls {pca:.3f}{ood_note}",
                flush=True,
            )
            # keep the BEST held-out checkpoint, not the final step; the
            # selection score weighs the paraphrase probe, the HARD OOD
            # probe (1.5: its leak tracks the dev rejection leak
            # superlinearly) and the noisy doc-junk probe (0.5)
            score = pa + ppa + 0.1 * ca
            if "ood-hard" in means:
                score += 1.5 * (1.0 - means["ood-hard"])
            if "doc-junk" in means:
                score += 0.5 * (1.0 - means["doc-junk"])
            if score > best_acc:
                best_acc = score
                best_step = done
                best_params = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}

    if best_params is None:
        best_params = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        best_step = done
    print(f"saving best checkpoint from step {best_step}")
    save_params(
        best_params,
        args.out,
        metadata={
            "reranker_config": cfg.to_json(),
            "trained_steps": str(best_step),
            # serving reads this to encode judge prompts at the trained
            # length with the trained truncation (models/reranker.py)
            "train_seq_len": str(args.seq_len),
        },
        half=True,
    )
    print(f"wrote {args.out}")

    # post-save verification: reload the file (the port's own reader) and
    # re-run the probes so a save/load divergence can never ship silently
    reloaded = load_params(args.out)
    fa, fb = flatten_params(best_params), flatten_params(reloaded)
    worst = max((float(np.max(np.abs(fa[k] - fb[k]))), k) for k in fa)
    print(f"reload max |delta| {worst[0]:.6f} ({worst[1]})")
    model.load_state_dict(reloaded)
    pa2, ca2 = eval_metrics(model, eval_pi, eval_pm, eval_ni, eval_nm)
    note2, _ = probe_notes(model)
    print(f"reloaded checkpoint: pair acc {pa2:.3f} cls acc {ca2:.3f}{note2}")
    print(json.dumps({"train_summary": log.summary(
        device, trainer="reranker", batch=args.batch, scan=args.scan, written=True, best_step=best_step,
        reload_max_abs_delta=worst[0], reload_pair_acc=pa2, reload_cls_acc=ca2, out=args.out)}), flush=True)


def _probe_prompts(held, queries: List[str], table: np.ndarray):
    """(ids, mask, query index) of every (junk query, retrieved held
    passage) prompt, or None when no query retrieved anything."""
    prompts, qid = [], []
    for r, q in enumerate(queries):
        for j in table[r][table[r] >= 0]:
            prompts.append(held._prompt(q, held.paragraphs[int(j)]))
            qid.append(r)
    if not prompts:
        return None
    ids, mask = held._encode(prompts)
    return ids, mask, np.asarray(qid)


if __name__ == "__main__":
    main()
