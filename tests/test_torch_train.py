"""The port's training (parallel/train.py, models/checkpoint.py, the two
trainers' main) against the JAX package's on the CPU.

Small configurations: vocab 256, dim 32, depth 2, heads 2, FFN 64, out_dim
48 (so out_proj is exercised), L 16. JAX parameters are carried into the
port with params_from_jax; inputs are seeded numpy. Tolerances:

  * f32 activations: loss rtol 1e-5; each gradient within rtol 1e-5 plus
    1e-6 of its largest element (f32 sums over the batch in other orders);
  * bf16 activations: loss within 2e-2, the global gradient cosine >= 0.999
    (the encoder tests' bounds for bf16: tests/test_torch_encoder.py);
  * the optimizer fed identical gradients: each step's learning rate
    within rtol 1e-6 of optax's (f32 cos in numpy and in XLA may differ in
    the last bit), parameters within 1e-6;
  * three AdamW steps through both packages' (4, 2) meshes: losses within
    1e-4 relative; parameters within 1e-4 wherever the first gradient is
    above 1e-6 (Adam turns a gradient of ~1e-9 into a +-lr update whose
    sign follows rounding: those elements are not compared);
  * the port's (4, 2) step against its (1, 1) step: 1e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rust_local_rag_tpu.models.checkpoint import save_params as jax_save_params
from rust_local_rag_tpu.models.encoder import EncoderConfig as JaxEncoderConfig
from rust_local_rag_tpu.models.encoder import init_encoder_params, load_encoder_checkpoint_full as jax_load_full
from rust_local_rag_tpu.models.reranker import RerankerConfig as JaxRerankerConfig
from rust_local_rag_tpu.models.reranker import init_reranker_params, reranker_forward_last_logits
from rust_local_rag_tpu.parallel import train as jtrain
from rust_local_rag_tpu.parallel.mesh import build_mesh as jax_build_mesh
from rust_local_rag_tpu.training import train_encoder as jax_train_encoder
from rust_local_rag_tpu_torch.models.checkpoint import (
    flatten_params,
    load_params,
    params_from_jax,
    params_to_jax,
    read_safetensors,
    save_params,
)
from rust_local_rag_tpu_torch.models.encoder import Encoder, EncoderConfig, load_encoder_checkpoint_full
from rust_local_rag_tpu_torch.models.reranker import Reranker, RerankerConfig
from rust_local_rag_tpu_torch.models.tokenizer import HashTokenizer
from rust_local_rag_tpu_torch.parallel import train as ttrain
from rust_local_rag_tpu_torch.parallel.mesh import build_mesh
from rust_local_rag_tpu_torch.training import train_encoder, train_reranker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOK = os.path.join(ROOT, "rust_local_rag_tpu", "assets", "tokenizer.json")
CORPUS = os.path.join(ROOT, ".cache", "train_corpus.txt")
SMALL = dict(vocab_size=256, dim=32, depth=2, heads=2, ffn_dim=64, max_len=16)
B, L = 8, 16


def _cfgs(act: str, out_dim: int = 48):
    kw = dict(SMALL, activation_dtype=act, out_dim=out_dim)
    return JaxEncoderConfig(**kw), EncoderConfig(**kw)


def _jax_params(cfg, seed: int = 0):
    return jax.device_get(init_encoder_params(jax.random.PRNGKey(seed), cfg))


def _encoder(jp, cfg) -> Encoder:
    m = Encoder(cfg)
    m.load_state_dict(params_from_jax(jp))
    return m


def _batch(seed: int, n: int = 3):
    """n (ids, mask) pairs [B, L]: random ids, ragged masks."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(4, 256, (B, L)).astype(np.int32)
        mask = (np.arange(L)[None] < rng.integers(3, L + 1, (B, 1))).astype(np.int32)
        out += [ids, mask]
    return out


def _grads(model) -> dict:
    return params_to_jax({k: p.grad for k, p in model.named_parameters()})


def _flat(tree) -> dict:
    return flatten_params(tree)


def _assert_grads_f32(got: dict, want: dict):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6 * float(np.abs(want[k]).max()), err_msg=k)


def _cosine(got: dict, want: dict) -> float:
    a = np.concatenate([v.ravel() for _, v in sorted(_flat(got).items())]).astype(np.float64)
    b = np.concatenate([v.ravel() for _, v in sorted(_flat(want).items())]).astype(np.float64)
    return float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))


# ------------------------------------------------------------------ losses ----


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
@pytest.mark.parametrize("hard_negatives", [False, True], ids=["in_batch", "hard_negatives"])
def test_info_nce_value_and_grad_equal_jax(act, hard_negatives):
    jcfg, cfg = _cfgs(act)
    jp = _jax_params(jcfg)
    batch = _batch(1, 3 if hard_negatives else 2)
    jfn = jtrain.info_nce_loss_hn if hard_negatives else jtrain.info_nce_loss
    tfn = ttrain.info_nce_loss_hn if hard_negatives else ttrain.info_nce_loss
    jl, jg = jax.value_and_grad(jfn)(jp, *batch, jcfg, 0.05)
    model = _encoder(jp, cfg)
    loss = tfn(model, *[torch.from_numpy(x) for x in batch], temperature=0.05)
    loss.backward()
    if act == "float32":
        np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
        _assert_grads_f32(_grads(model), jax.device_get(jg))
    else:
        assert abs(float(loss.detach()) - float(jl)) <= 2e-2
        assert _cosine(_grads(model), jax.device_get(jg)) >= 0.999


@pytest.mark.parametrize("hard_negatives", [False, True], ids=["in_batch", "hard_negatives"])
def test_info_nce_sharded_equals_plain(hard_negatives):
    """(4, 2) mesh: data-split forward, model-split blocks, one backward."""
    jcfg, cfg = _cfgs("float32")
    jp = _jax_params(jcfg, 3)
    batch = _batch(2, 3 if hard_negatives else 2)
    fn = ttrain.info_nce_loss_hn if hard_negatives else ttrain.info_nce_loss
    plain = _encoder(jp, cfg)
    want = fn(plain, *[torch.from_numpy(x) for x in batch])
    want.backward()
    mesh = build_mesh((4, 2), ("data", "model"), device="cpu")
    params = ttrain.shard_params(_encoder(jp, cfg), mesh)
    got = fn(params, *ttrain.place_batch(batch, mesh))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want.detach()), rtol=1e-6)
    for name, p in plain.named_parameters():
        blocks = params.blocks[name]
        g = torch.cat([b.grad for b in blocks], dim=params.specs[name].index("model")) if len(blocks) > 1 \
            else blocks[0].grad
        torch.testing.assert_close(g, p.grad, rtol=1e-5, atol=1e-6 * float(p.grad.abs().max()))


def _jax_reranker_loss(params, pi, pm, ni, nm, cfg, yes_id, no_id):
    """train_reranker.py:757-762 there (its loss_fn is local to main)."""
    def margins(ids, mask):
        logits = reranker_forward_last_logits(params, ids, mask, cfg, fused_attn=False)
        return logits[:, yes_id] - logits[:, no_id]

    mp, mn = margins(pi, pm), margins(ni, nm)
    pairwise = -jax.nn.log_sigmoid(mp - mn)
    cal = -jax.nn.log_sigmoid(mp) - jax.nn.log_sigmoid(-mn)
    return jnp.mean(pairwise) + 0.5 * jnp.mean(cal)


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_reranker_pair_loss_equal_jax(act):
    jcfg = JaxRerankerConfig(**SMALL, activation_dtype=act)
    cfg = RerankerConfig(**SMALL, activation_dtype=act)
    jp = jax.device_get(init_reranker_params(jax.random.PRNGKey(5), jcfg))
    batch = _batch(4, 2)
    jl, jg = jax.value_and_grad(_jax_reranker_loss)(jp, *batch, jcfg, 17, 23)
    model = Reranker(cfg)
    model.load_state_dict(params_from_jax(jp))
    loss = train_reranker.pair_loss(model, *[torch.from_numpy(x) for x in batch], 17, 23)
    loss.backward()
    if act == "float32":
        np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
        _assert_grads_f32(_grads(model), jax.device_get(jg))
    else:
        assert abs(float(loss.detach()) - float(jl)) <= 2e-2
        assert _cosine(_grads(model), jax.device_get(jg)) >= 0.999


# --------------------------------------------------------------- optimizer ----


def test_optimizer_equals_optax_chain():
    """Identical gradients for 6 steps: clip (some steps above the max
    norm, some below), AdamW with weight decay, warmup + cosine."""
    lr, warmup, steps, wd = 1e-2, 3, 6, 0.01
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((5, 7)).astype(np.float32), "b": rng.standard_normal(11).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * s).astype(np.float32) for k, v in params.items()}
             for s in (0.5, 0.01, 2.0, 0.05, 1.0, 0.02)]
    schedule = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, max(steps, warmup + 1))
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(schedule, weight_decay=wd))
    jp, state = dict(params), tx.init(params)
    ours = ttrain.make_optimizer(lr, warmup, steps, wd)
    leaves = [torch.tensor(params[k]) for k in ("a", "b")]
    ostate = ours.init(leaves)
    norms = []
    for t, g in enumerate(grads):
        np.testing.assert_allclose(ours.learning_rate(t), float(schedule(t)), rtol=1e-6, atol=0)
        norms.append(float(np.sqrt(sum((x.astype(np.float64) ** 2).sum() for x in g.values()))))
        updates, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
        for w, k in zip(leaves, ("a", "b")):
            w.grad = torch.tensor(g[k])
        ostate = ours.step(leaves, ostate)
        for w, k in zip(leaves, ("a", "b")):
            np.testing.assert_allclose(w.numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6, err_msg=f"step {t} {k}")
        if t == 0:  # optax's first update uses schedule(0) = 0
            np.testing.assert_array_equal(leaves[0].numpy(), params["a"])
    assert min(norms) < 1.0 < max(norms)  # both branches of the clip ran
    assert ours.learning_rate(0) == 0.0 and ours.learning_rate(warmup) == pytest.approx(lr)
    with pytest.raises(ValueError):
        ttrain.warmup_cosine_decay_schedule(0.0, lr, 5, 5)


# ------------------------------------------------------------ multi-step ----


def _stacks(seed: int, n_arrays: int, steps: int = 3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_arrays // 2):
        ids = rng.integers(4, 256, (steps, B, L)).astype(np.int32)
        mask = (np.arange(L)[None, None] < rng.integers(3, L + 1, (steps, B, 1))).astype(np.int32)
        out += [ids, mask]
    return out


@pytest.mark.parametrize("hard_negatives", [False, True], ids=["in_batch", "hard_negatives"])
def test_scan_step_on_4x2_mesh_equals_jax_and_1x1(hard_negatives):
    jcfg, cfg = _cfgs("float32")
    jp = _jax_params(jcfg, 7)
    stacks = _stacks(11, 6 if hard_negatives else 4)
    lr, warmup, steps = 1e-3, 1, 3

    schedule = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, max(steps, warmup + 1))
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(schedule, weight_decay=0.01))
    jmesh = jax_build_mesh((4, 2), ("data", "model"))
    jparams = jtrain.shard_params(jax.tree_util.tree_map(jnp.asarray, jp), jmesh, jcfg)
    jmake = jtrain.make_optax_scan_step_hn if hard_negatives else jtrain.make_optax_scan_step
    jparams, _, jloss = jmake(jmesh, jcfg, tx, 0.05)(jparams, tx.init(jparams), *stacks)
    jfinal = jax.device_get(jparams)
    jfn = jtrain.info_nce_loss_hn if hard_negatives else jtrain.info_nce_loss
    _, g0 = jax.value_and_grad(jfn)(jp, *[x[0] for x in stacks], jcfg, 0.05)
    g0 = _flat(jax.device_get(g0))

    make = ttrain.make_optax_scan_step_hn if hard_negatives else ttrain.make_optax_scan_step
    finals = {}
    for shape in ((4, 2), (1, 1)):
        mesh = build_mesh(shape, ("data", "model"), devices=["cpu"] * (shape[0] * shape[1]))
        params = ttrain.shard_params(_encoder(jp, cfg), mesh)
        ours = ttrain.make_optimizer(lr, warmup, steps, 0.01)
        params, state, loss = make(mesh, cfg, ours, 0.05)(params, ours.init(params.parameters()), *stacks)
        assert state.count == steps
        finals[shape] = (float(loss), _flat(params.state_dict()))
    np.testing.assert_allclose(finals[(4, 2)][0], float(jloss), rtol=1e-4)
    got, want = finals[(4, 2)][1], _flat(jfinal)
    for k in want:
        sel = np.abs(g0[k]) > 1e-6
        np.testing.assert_allclose(got[k][sel], want[k][sel], rtol=0, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(finals[(1, 1)][0], finals[(4, 2)][0], rtol=1e-5)
    for k in got:
        np.testing.assert_allclose(finals[(1, 1)][1][k], got[k], rtol=0, atol=1e-5, err_msg=k)


# ---------------------------- counterparts of tests/test_parallel.py ----


def test_distributed_train_step_runs_and_learns():
    """tests/test_parallel.py:98 on the port's (4, 2) mesh."""
    kw = dict(SMALL, activation_dtype="float32", out_dim=32)
    params = ttrain.shard_params(_encoder(_jax_params(JaxEncoderConfig(**kw)), EncoderConfig(**kw)),
                                 build_mesh((4, 2), ("data", "model"), device="cpu"))
    mesh = params.mesh
    step = ttrain.make_train_step(mesh, params.cfg, lr=1e-2)
    rng = np.random.default_rng(0)
    q_ids = rng.integers(4, 256, (B, L)).astype(np.int32)
    mask = np.ones((B, L), dtype=np.int32)
    batch = ttrain.place_batch((q_ids, mask, q_ids.copy(), mask), mesh)
    losses = []
    for _ in range(3):
        params, loss = step(params, *batch)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_train_params_actually_sharded():
    """tests/test_parallel.py:135: w_gate split on its hidden dim over
    "model", norms replicated; the blocks hold the whole parameter."""
    kw = dict(SMALL, activation_dtype="float32", depth=1, out_dim=32)
    cfg = EncoderConfig(**kw)
    model = _encoder(_jax_params(JaxEncoderConfig(**kw)), cfg)
    whole = {k: v.clone() for k, v in model.state_dict().items()}
    params = ttrain.shard_params(model, build_mesh((4, 2), ("data", "model"), device="cpu"))
    assert params.specs["layers.0.w_gate"] == (None, "model")
    assert params.specs["final_norm"] == () and params.specs["layers.0.attn_norm"] == ()
    assert [tuple(b.shape) for b in params.blocks["layers.0.w_gate"]] == [(32, 32), (32, 32)]
    assert [tuple(b.shape) for b in params.blocks["embed"]] == [(128, 32), (128, 32)]
    assert len(params.blocks["final_norm"]) == 1 and "out_proj" not in params.specs
    for k, v in params.state_dict().items():
        torch.testing.assert_close(v, whole[k], rtol=0, atol=0)
    with pytest.raises(ValueError, match="data"):
        ttrain.place_batch((np.zeros((6, L), np.int32),), params.mesh)
    with pytest.raises(ValueError, match="mesh"):
        ttrain.shard_params(model, build_mesh((8,), ("corpus",), device="cpu"))


def test_uneven_model_axis_refused_as_jax():
    """A vocabulary that does not divide over "model" (257 over 2) is
    refused by the port's shard_params, as jax.device_put refuses it on the
    JAX package's 8-device CPU mesh; a dividing one (256) is accepted."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    kw = dict(SMALL, vocab_size=257, activation_dtype="float32", out_dim=32)
    model = Encoder(EncoderConfig(**kw), torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match=r"embed \(257, 32\).*2 model shards"):
        ttrain.shard_params(model, build_mesh((1, 2), ("data", "model"), devices=["cpu"] * 2))
    jmesh = jax_build_mesh((4, 2), ("data", "model"))
    with pytest.raises(ValueError, match="divisible by 2"):
        jax.device_put(np.zeros((257, 32), np.float32), NamedSharding(jmesh, P("model", None)))
    even = Encoder(EncoderConfig(**dict(kw, vocab_size=256)), torch.Generator().manual_seed(1))
    params = ttrain.shard_params(even, build_mesh((1, 2), ("data", "model"), devices=["cpu"] * 2))
    assert [tuple(b.shape) for b in params.blocks["embed"]] == [(128, 32), (128, 32)]
    jax.device_put(np.zeros((256, 32), np.float32), NamedSharding(jmesh, P("model", None)))


def test_contrastive_training_improves_retrieval():
    """tests/test_train_quality.py:84 through the port: the same data, the
    same initial parameters, the port's (4, 2) mesh and SGD step."""
    import tests.test_train_quality as tq

    cfg = EncoderConfig(**{f: getattr(tq.CFG, f) for f in EncoderConfig.__dataclass_fields__})
    rng = np.random.default_rng(0)
    topics = tq._topic_vocab(rng)
    tok = HashTokenizer(vocab_size=cfg.vocab_size, max_len=tq.SEQ)
    mesh = build_mesh((4, 2), ("data", "model"), device="cpu")
    params = ttrain.shard_params(_encoder(_jax_params(tq.CFG), cfg), mesh)
    step = ttrain.make_train_step(mesh, cfg, lr=3e-3)

    def accuracy(seed):
        r = np.random.default_rng(seed)
        docs, doc_t, queries, q_t = [], [], [], []
        for t, (_, dv) in enumerate(topics):
            for _ in range(4):
                docs.append(tq._sample_text(r, dv))
                doc_t.append(t)
        for t, (qv, _) in enumerate(topics):
            for _ in range(4):
                queries.append(tq._sample_text(r, qv))
                q_t.append(t)
        with torch.no_grad():
            d = params.embed(*(torch.from_numpy(x) for x in tok.encode_batch(docs, buckets=(tq.SEQ,)))).numpy()
            q = params.embed(*(torch.from_numpy(x) for x in tok.encode_batch(queries, buckets=(tq.SEQ,)))).numpy()
        top1 = np.argmax(q @ d.T, axis=1)
        return float(np.mean([doc_t[j] == q_t[i] for i, j in enumerate(top1)]))

    before = accuracy(1)
    for _ in range(60):
        ts = rng.integers(0, tq.N_TOPICS, 16)
        q_ids, q_mask = tok.encode_batch([tq._sample_text(rng, topics[t][0]) for t in ts], buckets=(tq.SEQ,))
        p_ids, p_mask = tok.encode_batch([tq._sample_text(rng, topics[t][1]) for t in ts], buckets=(tq.SEQ,))
        params, _ = step(params, *ttrain.place_batch((q_ids, q_mask, p_ids, p_mask), mesh))
    after = accuracy(1)
    assert before < 0.5, before
    assert after > before + 0.3, (before, after)
    assert after >= 0.8, (before, after)


# ------------------------------------------------------------- checkpoints ----


def _f16_tol(w: np.ndarray) -> np.ndarray:
    """f16 storage rounds to nearest: half an ulp, 2^-11 of |w| for normal
    f16 values and 2^-25 below them (subnormals)."""
    return np.maximum(np.abs(w) * 2.0 ** -11, 2.0 ** -25)


def test_checkpoint_port_writes_jax_reads(tmp_path):
    jcfg, cfg = _cfgs("float32")
    jp = _jax_params(jcfg, 2)
    model = _encoder(jp, cfg)
    meta = {"encoder_config": jcfg.to_json(), "trained_steps": "12", "query_prefix": "search_query: "}
    for half in (False, True):
        path = str(tmp_path / f"port_{half}.safetensors")
        save_params(model, path, metadata=meta, half=half)
        params, jc, jmeta = jax_load_full(path)
        assert jc == jcfg and jmeta == meta
        got, want = _flat(jax.device_get(params)), _flat(jp)
        assert got.keys() == want.keys()
        for k in want:
            tol = _f16_tol(want[k]) if half else 0.0
            assert np.all(np.abs(got[k] - want[k]) <= tol), k
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_checkpoint_jax_writes_port_reads(tmp_path):
    jcfg, cfg = _cfgs("bfloat16")
    jp = _jax_params(jcfg, 4)
    path = str(tmp_path / "jax.safetensors")
    jax_save_params(jp, path, metadata={"encoder_config": jcfg.to_json(), "objective": "mixed"}, half=True)
    state, got_cfg, meta = load_encoder_checkpoint_full(path)
    assert got_cfg == cfg and meta == {"encoder_config": jcfg.to_json(), "objective": "mixed"}
    want = _flat(jp)
    for k, v in flatten_params(state).items():
        assert np.all(np.abs(v - want[k]) <= _f16_tol(want[k])), k
    assert load_params(path).keys() == state.keys()
    # and back: the port rewrites what it read, and the JAX loader agrees
    save_params(state, str(tmp_path / "again.safetensors"), metadata=meta, half=True)
    again, _, _ = jax_load_full(str(tmp_path / "again.safetensors"))
    for k, v in _flat(jax.device_get(again)).items():
        np.testing.assert_array_equal(v, flatten_params(state)[k])


def test_checkpoint_writes_transposed_tensor_correctly(tmp_path):
    """A non-contiguous (transposed) tensor is written in its logical order."""
    w = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    t = w.T
    assert not t.is_contiguous()
    path = str(tmp_path / "t.safetensors")
    save_params({"lm_head": t, "layers": [{"wq": w}]}, path)
    tensors, meta = read_safetensors(path)
    np.testing.assert_array_equal(tensors["lm_head"], t.numpy())
    np.testing.assert_array_equal(tensors["layers.0.wq"], w.numpy())
    assert meta == {}
    with pytest.raises(TypeError):
        save_params({"x": w}, path, metadata={"steps": 3})


def test_params_to_jax_inverts_params_from_jax():
    jcfg, _ = _cfgs("float32")
    jp = _jax_params(jcfg)
    back = params_to_jax(params_from_jax(jp))
    for k, v in _flat(jp).items():
        np.testing.assert_array_equal(_flat(back)[k], v)


# ------------------------------------------------- the trainers' main ----


@pytest.fixture
def corpus300(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))  # the premine caches
    path = tmp_path / "corpus.txt"
    with open(CORPUS, encoding="utf-8") as f:
        path.write_text("".join(next(f) for _ in range(300)), encoding="utf-8")
    return str(path)


TINY = ["--device", "cpu", "--dim", "32", "--depth", "2", "--heads", "2", "--ffn", "64"]


def _summary(out: str) -> dict:
    import json

    line = [ln for ln in out.splitlines() if ln.startswith('{"train_summary"')][-1]
    return json.loads(line)["train_summary"]


def test_train_encoder_main_writes_reloads_and_guards(corpus300, tmp_path, capsys):
    out = str(tmp_path / "enc" / "encoder.safetensors")
    args = ["--corpus", corpus300, "--tokenizer", TOK, "--steps", "4", "--scan", "2", "--batch", "16",
            "--warmup", "1", "--eval-every", "2", "--eval-bank", "32", "--out-dim", "48", "--hard-negatives"]
    train_encoder.main(args + TINY + ["--out", out])
    s = _summary(capsys.readouterr().out)
    assert s["written"] and s["steps"] == 4 and s["dispatches"] == 2 and np.isfinite(s["losses"]).all()
    assert s["fused_attention_launches"] == 0 and s["reload_max_abs_delta"] <= 2.0 ** -11 * 2
    state, cfg, meta = load_encoder_checkpoint_full(out)
    assert cfg.out_dim == 48 and cfg.vocab_size == 8193 and meta["query_prefix"] == "search_query: "
    # the warm-start guard: at lr 0 no eval beats the initial accuracy
    guarded = str(tmp_path / "guarded" / "encoder.safetensors")
    train_encoder.main(args + TINY + ["--init", out, "--lr", "0", "--out", guarded])
    text = capsys.readouterr().out
    assert "checkpoint NOT written" in text and not os.path.exists(guarded)
    assert _summary(text)["written"] is False
    with pytest.raises(FileNotFoundError, match="tokenizer"):
        train_encoder.main(["--corpus", corpus300, "--out", str(tmp_path / "x" / "e.safetensors")] + TINY)


def test_train_reranker_main_writes_and_reloads(corpus300, tmp_path, capsys):
    from rust_local_rag_tpu_torch.models.reranker import load_reranker_checkpoint

    out = str(tmp_path / "rr" / "reranker.safetensors")
    train_reranker.main(["--corpus", corpus300, "--tokenizer", TOK, "--steps", "4", "--scan", "2", "--batch", "8",
                         "--warmup", "1", "--eval-every", "2", "--readme-corpus", "0", "--seq-len", "64",
                         "--ood-frac", "0.2", "--junk-doc-frac", "0", "--junk-hard-frac", "0",
                         "--paraphrase-frac", "0.3", "--out", out] + TINY)
    text = capsys.readouterr().out
    s = _summary(text)
    assert s["written"] and s["steps"] == 4 and np.isfinite(s["losses"]).all() and s["fused_attention_launches"] == 0
    assert "ood yes-p mean" in text
    model, meta = load_reranker_checkpoint(out)
    assert meta["train_seq_len"] == "64" and model.cfg.dim == 32


def test_retrieval_accuracy_equals_jax():
    jcfg, cfg = _cfgs("float32")
    jp = _jax_params(jcfg, 9)
    rng = np.random.default_rng(3)
    ids = rng.integers(4, 256, (40, L)).astype(np.int32)
    mask = (np.arange(L)[None] < rng.integers(2, L + 1, (40, 1))).astype(np.int32)
    p_ids = np.where(rng.random((40, L)) < 0.5, ids, rng.integers(4, 256, (40, L))).astype(np.int32)
    bank = (ids, mask, p_ids, mask)
    want = jax_train_encoder.retrieval_accuracy(jax.tree_util.tree_map(jnp.asarray, jp), jcfg, bank, batch=16)
    model = _encoder(jp, cfg)
    assert train_encoder.retrieval_accuracy(model, cfg, bank, batch=16) == want
    params = ttrain.shard_params(_encoder(jp, cfg), build_mesh((4, 2), ("data", "model"), device="cpu"))
    assert train_encoder.retrieval_accuracy(params, cfg, bank, batch=16) == want
    assert 0.0 < want < 1.0
