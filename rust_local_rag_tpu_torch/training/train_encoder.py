"""Contrastive encoder training (port of rust_local_rag_tpu/training/train_encoder.py).

Trains the retrieval encoder (models/encoder.py) on locally harvested
documentation prose (training/corpus.py) with the Contriever recipe
(training/pairs.py) and saves a serving checkpoint (f16 storage,
architecture config and task prefixes in the safetensors metadata) that
the port's load_encoder_checkpoint and the JAX package's loaders read.

Run on the card (every card the process sees forms the "data" axis of
the mesh; parallel/train.py):
    python -m rust_local_rag_tpu_torch.training.train_encoder \\
        --corpus .cache/train_corpus.txt --steps 8000 \\
        --tokenizer rust_local_rag_tpu/assets/tokenizer.json --out /tmp/enc/encoder.safetensors

The tokenizer defaults to tokenizer.json beside --out, so a run whose
--out lies elsewhere than the committed assets must pass --tokenizer.
--device cpu runs on the CPU (the tests do); the default is the card, and
the trainer raises without one.

The quality eval's corpus passages are held out of training unless
--no-exclude-eval is set: training/corpus.eval_passage_hashes gives the
passage hashes eval_harness.corpus.passage_hashes gives.

The encoder v5 negative result (reranker-denoised dense negatives,
--dense-negatives) is recorded in the JAX package's trainer: held-out
crop accuracy rose while the held-out eval split regressed, so dense
negatives stay off the encoder recipe.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional

import numpy as np
import torch


def _default_out() -> str:
    from rust_local_rag_tpu_torch.models.encoder import default_asset

    return default_asset("encoder.safetensors")


def _embed_fn(params):
    """The [B, L] -> [B, out_dim] forward of an Encoder or ShardedParams
    (plain attention) on the weights' (lead) device."""
    from rust_local_rag_tpu_torch.parallel.train import ShardedParams

    if isinstance(params, ShardedParams):
        return params.embed
    dev = next(params.parameters()).device
    return lambda ids, mask: params(ids.to(dev), mask.to(dev), fused_attn=False)


def retrieval_accuracy(params, cfg, bank, batch: int = 256) -> float:
    """Top-1 accuracy of crop-A retrieving crop-B among the bank."""
    fwd = _embed_fn(params)
    q_ids, q_mask, p_ids, p_mask = bank

    def embed(ids, mask):
        outs = []
        with torch.no_grad():
            for lo in range(0, ids.shape[0], batch):
                outs.append(fwd(torch.from_numpy(ids[lo : lo + batch]),
                                torch.from_numpy(mask[lo : lo + batch])).float().cpu().numpy())
        return np.concatenate(outs)

    q = embed(q_ids, q_mask)
    p = embed(p_ids, p_mask)
    sims = q @ p.T
    return float((sims.argmax(axis=1) == np.arange(len(q))).mean())


def training_tokenizer(path: str):
    """The port's WordPiece tokenizer for a tokenizer.json that must exist
    (the hash tokenizer has no vocabulary to train against)."""
    from rust_local_rag_tpu_torch.models.tokenizer import load_tokenizer

    if not os.path.exists(path):
        raise FileNotFoundError(f"tokenizer {path} not found (pass --tokenizer)")
    return load_tokenizer(path, max_len=512)


def split_holdout(paragraphs: List[str], seed: int, holdout: int):
    """The deterministic split: a seeded permutation, its tail (min(holdout,
    n // 10) paragraphs) held out -> (train, held)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(paragraphs))
    hold_n = min(holdout, len(paragraphs) // 10)
    return [paragraphs[i] for i in order[:-hold_n]], [paragraphs[i] for i in order[-hold_n:]]


def load_training_paragraphs(corpus: Optional[str], exclude_eval: bool) -> tuple:
    """-> (paragraphs, exclude hash set or None): the --corpus file (or a
    fresh harvest) without the eval passages unless exclude_eval is off."""
    from rust_local_rag_tpu_torch.training.corpus import (
        eval_passage_hashes,
        harvest,
        load_paragraphs,
        normalized_hash,
    )

    exclude = None
    if exclude_eval:
        try:
            exclude = eval_passage_hashes()
            print(f"holding out {len(exclude)} eval passages from training")
        except ImportError:
            print("eval_harness passage hashes unavailable; no holdout")
    if corpus:
        paragraphs = load_paragraphs(corpus)
        if exclude:
            before = len(paragraphs)
            paragraphs = [p for p in paragraphs if normalized_hash(p) not in exclude]
            print(f"holdout dropped {before - len(paragraphs)} paragraphs")
    else:
        paragraphs = harvest(exclude_hashes=exclude)
    return paragraphs, exclude


class DispatchLog:
    """Per dispatch: host seconds building the batch, seconds of the device
    steps (ended by reading the loss), the loss; and the summary line."""

    def __init__(self, batch: int):
        self.batch = batch
        self.rows: List[dict] = []
        self.t0 = time.monotonic()

    def add(self, steps: int, host_s: float, device_s: float, loss: float) -> None:
        self.rows.append({"steps": steps, "host_s": host_s, "device_s": device_s, "loss": loss})

    def summary(self, device: torch.device, **extra) -> dict:
        from rust_local_rag_tpu_torch.ops.attention import fused_attention

        steps = sum(r["steps"] for r in self.rows)
        dev_s = sum(r["device_s"] for r in self.rows)
        host_s = sum(r["host_s"] for r in self.rows)
        out = {
            "device": str(device),
            "device_name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "steps": steps,
            "dispatches": len(self.rows),
            "losses": [r["loss"] for r in self.rows],
            "host_s": host_s,
            "device_s": dev_s,
            "dispatch_split": [[r["host_s"], r["device_s"]] for r in self.rows],
            "steps_per_s": steps / max(host_s + dev_s, 1e-9),
            "pairs_per_s": steps * self.batch / max(host_s + dev_s, 1e-9),
            "device_steps_per_s": steps / max(dev_s, 1e-9),
            "wall_s": time.monotonic() - self.t0,
            "peak_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None,
            "fused_attention_launches": fused_attention.launches,
        }
        out.update(extra)
        return out


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--corpus", help="pre-harvested paragraph file")
    ap.add_argument("--steps", type=int, default=8000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--scan", type=int, default=16, help="steps per dispatch")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=400)
    ap.add_argument("--weight-decay", type=float, default=0.01)
    ap.add_argument("--temperature", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--ffn", type=int, default=1408)
    ap.add_argument("--out-dim", type=int, default=768)
    ap.add_argument("--out", default=_default_out())
    ap.add_argument("--tokenizer", default=None, help="default: tokenizer.json beside --out")
    ap.add_argument(
        "--objective",
        choices=("mixed", "ict", "symmetric"),
        default="mixed",
        help="mixed = ICT + lead-to-rest + crop pairs with dual task "
        "prefixes (default); ict = short query crop vs source passage; "
        "symmetric = Contriever-style crop pairs",
    )
    ap.add_argument(
        "--init",
        default=None,
        help="warm-start from an existing checkpoint (architecture args "
        "are ignored; the config embedded in the checkpoint wins)",
    )
    ap.add_argument(
        "--hard-negatives",
        action="store_true",
        help="DPR-style explicit hard negatives: each pair additionally "
        "carries a BM25-mined keyword-trap passage (premined once) in the "
        "InfoNCE denominator",
    )
    ap.add_argument(
        "--dense-negatives",
        action="store_true",
        help="v5 recipe: ALSO mine negatives with the committed dense "
        "encoder and denoise them with the committed reranker "
        "(training/mining.py); mined negatives then draw 50/50 from the "
        "BM25 and dense tables. Implies --hard-negatives.",
    )
    ap.add_argument(
        "--dense-margin",
        type=float,
        default=0.0,
        help="reranker yes/no logit-margin above which a dense-mined "
        "neighbor is judged a false negative and dropped",
    )
    ap.add_argument("--eval-every", type=int, default=1600)
    ap.add_argument("--eval-bank", type=int, default=1024)
    ap.add_argument("--holdout", type=int, default=2048,
                    help="paragraphs reserved for the eval bank")
    ap.add_argument(
        "--no-exclude-eval",
        action="store_true",
        help="do NOT hold the quality-eval corpus passages out of training",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default: every card) or cpu")
    args = ap.parse_args(argv)
    if args.dense_negatives:
        args.hard_negatives = True

    from rust_local_rag_tpu_torch.device import resolve_device
    from rust_local_rag_tpu_torch.models.checkpoint import flatten_params, save_params
    from rust_local_rag_tpu_torch.models.encoder import Encoder, EncoderConfig, load_encoder_checkpoint_full
    from rust_local_rag_tpu_torch.parallel.mesh import available_devices, build_mesh
    from rust_local_rag_tpu_torch.parallel.train import (
        make_optax_scan_step,
        make_optax_scan_step_hn,
        make_optimizer,
        shard_params,
    )
    from rust_local_rag_tpu_torch.training.pairs import P_LEN, PairBatcher

    device = resolve_device(args.device)
    tok_path = args.tokenizer or os.path.join(os.path.dirname(args.out), "tokenizer.json")
    tokenizer = training_tokenizer(tok_path)

    paragraphs, _ = load_training_paragraphs(args.corpus, not args.no_exclude_eval)
    print(f"{len(paragraphs)} training paragraphs")

    # deterministic split: tail paragraphs are the held-out eval bank
    train_pars, held_pars = split_holdout(paragraphs, args.seed, args.holdout)

    prefixes = {}
    if args.objective in ("mixed", "ict"):
        # dual task prefixes, nomic-embed-text-class; recorded in the
        # checkpoint metadata so the serving encoder applies them too
        prefixes = {
            "query_prefix": "search_query: ",
            "doc_prefix": "search_document: ",
        }
    batcher = PairBatcher(train_pars, tokenizer, seed=args.seed, **prefixes)
    held = PairBatcher(held_pars, tokenizer, seed=args.seed, **prefixes)
    if args.objective == "mixed":
        bank = held.ict_eval_bank(args.eval_bank)
        if args.hard_negatives:
            batcher.premine_hard_negatives()
            if args.dense_negatives:
                batcher.premine_dense_negatives(margin=args.dense_margin, device=device)
            make_batches = batcher.mixed_hn_stacked_batches
        else:
            make_batches = batcher.mixed_stacked_batches
    elif args.objective == "ict":
        bank = held.ict_eval_bank(args.eval_bank)
        make_batches = batcher.ict_stacked_batches
    else:
        bank = held.eval_bank(args.eval_bank)
        make_batches = batcher.stacked_batches
    print(
        f"{len(batcher.docs)} croppable train docs, bank {bank[0].shape[0]} "
        f"({args.objective})"
    )

    if args.init:
        state, cfg, init_meta = load_encoder_checkpoint_full(args.init)
        if cfg is None:
            raise ValueError(f"{args.init}: no encoder_config in the safetensors metadata")
        model = Encoder(cfg)
        model.load_state_dict(state)
        print(
            f"warm start from {args.init} "
            f"(steps={init_meta.get('trained_steps')}, cfg {cfg.depth}L x "
            f"{cfg.dim}d -> {cfg.out_dim})"
        )
    else:
        cfg = EncoderConfig(
            vocab_size=tokenizer.vocab_size,
            dim=args.dim,
            depth=args.depth,
            heads=args.heads,
            ffn_dim=args.ffn,
            out_dim=args.out_dim,
        )
        model = Encoder(cfg, torch.Generator().manual_seed(args.seed))

    devices = available_devices(device)
    mesh = build_mesh((len(devices), 1), ("data", "model"), devices=devices)
    params = shard_params(model, mesh, cfg)
    del model

    tx = make_optimizer(args.lr, args.warmup, args.steps, args.weight_decay)
    opt_state = tx.init(params.parameters())
    if args.hard_negatives:
        step_fn = make_optax_scan_step_hn(mesh, cfg, tx, args.temperature)
    else:
        step_fn = make_optax_scan_step(mesh, cfg, tx, args.temperature)

    acc0 = retrieval_accuracy(params, cfg, bank)
    print(f"step 0: held-out retrieval acc {acc0:.3f} (chance "
          f"{1.0 / bank[0].shape[0]:.4f})")

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    log = DispatchLog(args.batch)
    best_acc, best_params, best_step = acc0 if args.init else -1.0, None, 0
    done = 0
    dispatch = 0
    while done < args.steps:
        s = min(args.scan, args.steps - done)
        t_host = time.perf_counter()
        if args.objective in ("mixed", "ict"):
            # every 4th dispatch trains the passage side at the serving
            # bucket (256) so rope/pooling see full-length chunks
            p_len = 256 if dispatch % 4 == 3 else P_LEN
            batch = make_batches(s, args.batch, p_len)
        else:
            batch = make_batches(s, args.batch)
        dispatch += 1
        if s < args.scan:  # pad the scan axis, as the JAX trainer does
            reps = args.scan - s
            batch = tuple(
                np.concatenate([a, a[-1:].repeat(reps, 0)]) for a in batch
            )
        t_dev = time.perf_counter()
        params, opt_state, loss = step_fn(params, opt_state, *batch)
        loss = float(loss)  # waits for the device
        log.add(args.scan, t_dev - t_host, time.perf_counter() - t_dev, loss)
        done += args.scan
        if done % max(args.scan * 4, 64) == 0 or done >= args.steps:
            dt = time.monotonic() - log.t0
            print(
                f"step {done}/{args.steps} loss {loss:.4f} "
                f"({done / dt:.1f} steps/s, "
                f"{done * args.batch / dt:.0f} pairs/s)",
                flush=True,
            )
        if args.eval_every and (done % args.eval_every == 0 or done >= args.steps):
            acc = retrieval_accuracy(params, cfg, bank)
            print(f"step {done}: held-out retrieval acc {acc:.3f}", flush=True)
            if acc > best_acc:
                best_acc, best_step = acc, done
                best_params = params.state_dict()

    summary = dict(trainer="encoder", batch=args.batch, scan=args.scan, acc0=acc0)
    if best_params is None:
        if args.init and args.eval_every:
            # warm-start regression guard: no eval ever beat the
            # warm-start accuracy, so the final (drifted) params must NOT
            # replace the initial checkpoint (which may be the committed
            # serving asset)
            print(
                f"no eval beat the warm-start acc {best_acc:.3f}; "
                f"checkpoint NOT written (init: {args.init})"
            )
            print(json.dumps({"train_summary": log.summary(device, written=False, **summary)}), flush=True)
            return
        # cold start (or eval disabled): save final
        best_params, best_step = params.state_dict(), done
    print(f"saving best checkpoint from step {best_step} (acc {best_acc:.3f})")
    save_params(
        best_params,
        args.out,
        metadata={
            "encoder_config": cfg.to_json(),
            "trained_steps": str(best_step),
            "train_paragraphs": str(len(train_pars)),
            "objective": args.objective,
            **(
                {
                    "query_prefix": prefixes["query_prefix"],
                    "document_prefix": prefixes["doc_prefix"],
                }
                if prefixes
                else {}
            ),
        },
        half=True,
    )
    print(f"wrote {args.out}")

    # post-save verification (the non-contiguous-save bug shipped
    # scrambled tensors once — models/checkpoint.py flatten_params):
    # reload and confirm the file matches what was trained, beyond f16
    # rounding, and that the eval-bank accuracy survives the roundtrip
    reloaded, rcfg, _ = load_encoder_checkpoint_full(args.out)
    fa, fb = flatten_params(best_params), flatten_params(reloaded)
    worst = max((float(np.max(np.abs(fa[k] - fb[k]))), k) for k in fa)
    print(f"reload max |delta| {worst[0]:.6f} ({worst[1]})")
    model = Encoder(rcfg or cfg)
    model.load_state_dict(reloaded)
    acc2 = retrieval_accuracy(model.to(mesh.lead), rcfg or cfg, bank)
    print(f"reloaded checkpoint: held-out retrieval acc {acc2:.3f}")
    print(json.dumps({"train_summary": log.summary(
        device, written=True, best_step=best_step, best_acc=best_acc, reload_max_abs_delta=worst[0],
        reload_acc=acc2, out=args.out, **summary)}), flush=True)


if __name__ == "__main__":
    main()
