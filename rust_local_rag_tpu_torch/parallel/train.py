"""Contrastive training of the embedding encoder over a device mesh (port
of rust_local_rag_tpu/parallel/train.py).

InfoNCE over (query, positive) pairs with in-batch negatives, optionally
with one mined hard negative a pair, and the optimizer both trainers use
(clip by global norm, then AdamW on a warmup + cosine schedule: the optax
chain the JAX trainers build).

One controller, as the JAX package is (jax.jit with NamedSharding over a
("data", "model") mesh, no jax.distributed): one process drives every
device of a parallel/mesh.Mesh, with no torch.distributed process group.

  * shard_params stores each parameter split over "model" as
    param_partition_specs says (attention projections on their output
    dim, wo and w_down on their input dim, the SwiGLU FFN on its hidden
    dim, the token embedding on the vocab dim; norms replicated), each
    block on the device of its position in the first data row.
  * place_batch splits a batch over "data".
  * A step embeds each data shard's rows on its own device with the
    weights gathered there (store sharded, compute gathered), brings the
    embeddings to the lead device for the global-batch InfoNCE (what
    GSPMD computes) and runs one backward. Autograd sums each weight
    block's gradient over the data shards: that sum is the all-reduce.
    The clip's global norm is one sum over all blocks.

The JAX package's lax.scan of S steps per dispatch is a Python loop of S
steps here that returns the mean loss. Attention is the plain path
(fused_attn=False) everywhere in training: the JAX trainers call the
models that way because pallas_call has no VJP, so no kernel of the port
runs in training.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call

from rust_local_rag_tpu_torch.models.encoder import Encoder, EncoderConfig
from rust_local_rag_tpu_torch.parallel.mesh import Mesh, ShardedTensor

DATA, MODEL = "data", "model"


def param_partition_specs(cfg: EncoderConfig) -> Dict[str, tuple]:
    """{state_dict name: PartitionSpec-like tuple} over ("data", "model");
    () is replicated."""
    layer = {
        "attn_norm": (),
        "wq": (None, MODEL),
        "wk": (None, MODEL),
        "wv": (None, MODEL),
        "wo": (MODEL, None),
        "ffn_norm": (),
        "w_gate": (None, MODEL),
        "w_up": (None, MODEL),
        "w_down": (MODEL, None),
    }
    specs = {"embed": (MODEL, None), "final_norm": ()}
    for i in range(cfg.depth):
        specs.update({f"layers.{i}.{name}": spec for name, spec in layer.items()})
    if cfg.out_dim != cfg.dim:
        specs["out_proj"] = (None, MODEL)
    return specs


def _data_devices(mesh: Mesh) -> List[torch.device]:
    """The device of each data shard (its position in the first model column)."""
    rows = mesh.devices.reshape(mesh.shape[DATA], -1)
    return [torch.device(d) for d in rows[:, 0]]


class ShardedParams:
    """Encoder parameters stored split over the mesh's "model" axis.

    blocks[name] holds one leaf tensor (requires_grad) a model shard, on
    the device of mesh position (0, shard); a replicated parameter is one
    leaf on the lead device. A sharded dim must divide over the shards:
    one that does not raises ValueError, as jax.device_put refuses it in
    the JAX package (the committed vocabulary of 8,193 rows therefore
    trains on a model axis of 1, as the JAX trainer's (devices, 1) mesh
    runs it). A storage-free copy of the encoder module supplies the
    forward (torch.func.functional_call)."""

    def __init__(self, model: Encoder, mesh: Mesh, specs: Dict[str, tuple]):
        if tuple(mesh.axis_names) != (DATA, MODEL):
            raise ValueError(f"training needs a ('data', 'model') mesh, got {mesh.axis_names}")
        self.mesh = mesh
        self.cfg = model.cfg
        self.specs = specs
        n_model = mesh.shape[MODEL]
        self.blocks: Dict[str, List[torch.Tensor]] = {}
        for name, value in model.state_dict().items():
            spec = specs[name]
            if MODEL not in spec:
                self.blocks[name] = [value.detach().to(mesh.lead, torch.float32).clone().requires_grad_(True)]
                continue
            dim = spec.index(MODEL)
            if value.shape[dim] % n_model:
                raise ValueError(f"{name} {tuple(value.shape)}: dim {dim} ({value.shape[dim]}) does not divide "
                                 f"over {n_model} model shards")
            pieces = torch.chunk(value.detach(), n_model, dim)
            self.blocks[name] = [
                p.to(mesh.devices[0, m], torch.float32).contiguous().clone().requires_grad_(True)
                for m, p in enumerate(pieces)
            ]
        with torch.device("meta"):  # the forward alone: no storage
            self._module = type(model)(model.cfg, torch.Generator())

    def parameters(self) -> List[torch.Tensor]:
        return [b for blocks in self.blocks.values() for b in blocks]

    def zero_grad(self) -> None:
        for b in self.parameters():
            b.grad = None

    def _full(self, name: str, device: torch.device) -> torch.Tensor:
        blocks = self.blocks[name]
        if len(blocks) == 1:
            return blocks[0] if blocks[0].device == device else blocks[0].to(device)
        return torch.cat([b.to(device) for b in blocks], dim=self.specs[name].index(MODEL))

    def gathered(self, device) -> Dict[str, torch.Tensor]:
        """Every weight whole on `device` (differentiable back to the blocks)."""
        device = torch.device(device)
        return {name: self._full(name, device) for name in self.blocks}

    def embed(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Unsharded forward on the lead device (any batch size)."""
        lead = self.mesh.lead
        return functional_call(self._module, self.gathered(lead), (ids.to(lead), mask.to(lead)),
                               {"fused_attn": False})

    def __call__(self, ids, mask, fused_attn: Optional[bool] = None) -> torch.Tensor:
        """[B, L] ids and mask (placed with place_batch, or whole) -> [B,
        out_dim] embeddings on the lead device: each data shard's rows
        embedded on its own device. fused_attn is ignored (always the
        plain path: training)."""
        ids = ids if isinstance(ids, ShardedTensor) else place_batch((ids,), self.mesh)[0]
        mask = mask if isinstance(mask, ShardedTensor) else place_batch((mask,), self.mesh)[0]
        outs = []
        for dev, i, m in zip(_data_devices(self.mesh), ids.shards(), mask.shards()):
            out = functional_call(self._module, self.gathered(dev), (i, m), {"fused_attn": False})
            outs.append(out.to(self.mesh.lead))
        return torch.cat(outs)

    def state_dict(self, device="cpu") -> Dict[str, torch.Tensor]:
        """Every parameter whole, detached, on `device`."""
        with torch.no_grad():
            return {name: self._full(name, torch.device(device)).detach().clone() for name in self.blocks}


def shard_params(model: Encoder, mesh: Mesh, cfg: Optional[EncoderConfig] = None) -> ShardedParams:
    """The model's parameters stored as param_partition_specs says."""
    return ShardedParams(model, mesh, param_partition_specs(cfg or model.cfg))


def place_batch(batch: Sequence, mesh: Mesh) -> Tuple[ShardedTensor, ...]:
    """Each [B, ...] array or tensor split over "data" (replicated over
    "model"): shard d on the device of mesh position (d, 0)."""
    out = []
    for x in batch:
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
        if t.shape[0] % mesh.shape[DATA]:
            raise ValueError(f"batch of {t.shape[0]} rows does not divide over {mesh.shape[DATA]} data shards")
        out.append(ShardedTensor.from_tensor(mesh, DATA, t))
    return tuple(out)


def _embed(model, ids, mask) -> torch.Tensor:
    return model(ids, mask, fused_attn=False)


def info_nce_loss(model, q_ids, q_mask, p_ids, p_mask, temperature: float = 0.05) -> torch.Tensor:
    """Symmetric InfoNCE with in-batch negatives. `model` is an Encoder or
    ShardedParams; the plain attention path (differentiable)."""
    logits = (_embed(model, q_ids, q_mask) @ _embed(model, p_ids, p_mask).T) / temperature
    loss_qp = -torch.log_softmax(logits, dim=1).diagonal().mean()
    loss_pq = -torch.log_softmax(logits.T, dim=1).diagonal().mean()
    return 0.5 * (loss_qp + loss_pq)


def info_nce_loss_hn(model, q_ids, q_mask, p_ids, p_mask, n_ids, n_mask, temperature: float = 0.05) -> torch.Tensor:
    """InfoNCE with explicit hard negatives (DPR-style): each query scores
    against [positives; mined negatives], a [B, 2B] softmax whose column i
    is its positive and column B + i its own mined negative; the
    passage -> query direction uses the positive block only."""
    q = _embed(model, q_ids, q_mask)
    p = _embed(model, p_ids, p_mask)
    n = _embed(model, n_ids, n_mask)
    logits_p = (q @ p.T) / temperature
    logits_n = (q @ n.T) / temperature
    logits = torch.cat([logits_p, logits_n], dim=1)
    loss_qp = -torch.log_softmax(logits, dim=1).diagonal().mean()
    loss_pq = -torch.log_softmax(logits_p.T, dim=1).diagonal().mean()
    return 0.5 * (loss_qp + loss_pq)


# ---------------------------------------------------------------- optimizer ----


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule, in f32 as optax computes it: a
    linear ramp from init_value to peak_value over warmup_steps, then a
    cosine from peak_value to end_value over decay_steps - warmup_steps."""
    f32 = np.float32
    alpha = f32(0.0) if peak_value == 0 else f32(end_value) / f32(peak_value)
    cos_steps = f32(decay_steps - warmup_steps)
    if not cos_steps > 0:
        raise ValueError(f"cosine decay needs decay_steps > warmup_steps, got {decay_steps}, {warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = f32(1) - f32(min(max(count, 0), warmup_steps)) / f32(warmup_steps)
            return float((f32(init_value) - f32(peak_value)) * frac + f32(peak_value))
        c = min(f32(count - warmup_steps), cos_steps)
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / cos_steps, dtype=f32))
        return float(f32(peak_value) * ((f32(1) - alpha) * cosine + alpha))

    return schedule


class AdamWState:
    """Moments a leaf and the update count (optax's ScaleByAdamState and
    ScaleByScheduleState count together)."""

    def __init__(self, mu: List[torch.Tensor], nu: List[torch.Tensor], count: int = 0):
        self.mu, self.nu, self.count = mu, nu, count


class ClipAdamW:
    """optax.chain(clip_by_global_norm(max_norm), adamw(schedule,
    weight_decay=...)) on torch leaves, step for step:

      g <- g if |g| < max_norm else (g / |g|) * max_norm   (|g| over all leaves)
      mu <- (1 - b1) g + b1 mu;  nu <- (1 - b2) g^2 + b2 nu
      u <- (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) + weight_decay w
      w <- w - schedule(t - 1) u

    with t the 1-based step. optax's first update uses schedule(0), which
    a warmup from 0 makes 0. torch.nn.utils.clip_grad_norm_ is not used:
    it adds 1e-6 to the norm."""

    def __init__(self, schedule: Callable[[int], float], weight_decay: float = 1e-4, max_norm: float = 1.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.max_norm = max_norm
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, leaves: Sequence[torch.Tensor]) -> AdamWState:
        return AdamWState([torch.zeros_like(w, dtype=torch.float32) for w in leaves],
                          [torch.zeros_like(w, dtype=torch.float32) for w in leaves])

    def learning_rate(self, count: int) -> float:
        return self.schedule(count)

    @torch.no_grad()
    def step(self, leaves: Sequence[torch.Tensor], state: AdamWState) -> AdamWState:
        """Apply one update to `leaves` in place from their .grad (a leaf
        without a gradient counts as a zero gradient)."""
        grads = [w.grad if w.grad is not None else torch.zeros_like(w) for w in leaves]
        lead = grads[0].device
        norm = torch.sqrt(sum(torch.sum(g.float() * g.float()).to(lead) for g in grads))
        keep = norm < self.max_norm
        b1, b2 = self.b1, self.b2
        t = state.count + 1
        f32 = np.float32
        c1 = float(f32(1) - f32(b1) ** f32(t))
        c2 = float(f32(1) - f32(b2) ** f32(t))
        lr = self.schedule(state.count)
        for w, g, mu, nu in zip(leaves, grads, state.mu, state.nu):
            n = norm.to(g.device)
            g = torch.where(keep.to(g.device), g, (g / n) * self.max_norm)
            mu.mul_(b1).add_((1 - b1) * g)
            nu.mul_(b2).add_((1 - b2) * (g * g))
            u = (mu / c1) / (torch.sqrt(nu / c2) + self.eps) + self.weight_decay * w
            w.add_(-lr * u)
        state.count = t
        return state


def make_optimizer(lr: float, warmup: int, steps: int, weight_decay: float, max_norm: float = 1.0) -> ClipAdamW:
    """The trainers' optimizer: warmup_cosine_decay_schedule(0, lr, warmup,
    max(steps, warmup + 1)), clip_by_global_norm(max_norm), adamw(schedule,
    weight_decay)."""
    return ClipAdamW(warmup_cosine_decay_schedule(0.0, lr, warmup, max(steps, warmup + 1)), weight_decay, max_norm)


# -------------------------------------------------------------------- steps ----


def make_train_step(mesh: Mesh, cfg: EncoderConfig, lr: float = 1e-4):
    """Plain SGD: step(params, q_ids, q_mask, p_ids, p_mask) -> (params, loss),
    params (ShardedParams) updated in place; the batch split over "data"."""

    def step(params: ShardedParams, q_ids, q_mask, p_ids, p_mask):
        batch = [x if isinstance(x, ShardedTensor) else place_batch((x,), mesh)[0]
                 for x in (q_ids, q_mask, p_ids, p_mask)]
        params.zero_grad()
        loss = info_nce_loss(params, *batch)
        loss.backward()
        with torch.no_grad():
            for w in params.parameters():
                if w.grad is not None:
                    w.add_(-lr * w.grad)
        return params, loss.detach()

    return step


def _scan_step(mesh: Mesh, tx: ClipAdamW, loss_fn, temperature: float):
    def step(params: ShardedParams, opt_state: AdamWState, *stacks):
        """[S, B, L] stacks -> S optimizer steps; -> (params, opt_state, mean loss)."""
        stacks = [x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x)) for x in stacks]
        leaves = params.parameters()
        losses = []
        for s in range(stacks[0].shape[0]):
            batch = place_batch([x[s] for x in stacks], mesh)
            params.zero_grad()
            loss = loss_fn(params, *batch, temperature=temperature)
            loss.backward()
            opt_state = tx.step(leaves, opt_state)
            losses.append(loss.detach())
        params.zero_grad()
        return params, opt_state, torch.stack(losses).mean()

    return step


def make_optax_scan_step(mesh: Mesh, cfg: EncoderConfig, tx: ClipAdamW, temperature: float = 0.05):
    """S optimizer steps a dispatch on [S, B, L] stacks of (q_ids, q_mask,
    p_ids, p_mask): step(params, opt_state, *stacks) -> (params, opt_state,
    mean loss); params and opt_state updated in place."""
    return _scan_step(mesh, tx, info_nce_loss, temperature)


def make_optax_scan_step_hn(mesh: Mesh, cfg: EncoderConfig, tx: ClipAdamW, temperature: float = 0.05):
    """make_optax_scan_step with hard negatives: stacks of (q_ids, q_mask,
    p_ids, p_mask, n_ids, n_mask) and info_nce_loss_hn."""
    return _scan_step(mesh, tx, info_nce_loss_hn, temperature)

