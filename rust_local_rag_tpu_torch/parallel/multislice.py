"""Multi-slice corpus sharding: the two-level exact top-k (port of
rust_local_rag_tpu/parallel/multislice.py).

The corpus is row-sharded over a ("slice", "ici") mesh, slice-major. Each
shard computes its exact local top-k; the first level merges the shards
of a slice (ICI in the JAX package's multi-slice deployment, the links
between the cards of one host here) down to k candidates on the slice's
lead device; the second merges the slices' k each (DCN there) on the
mesh's lead device. A flat merge would carry n_shards * k candidates
over the outer links; the hierarchy carries k a slice. Exactness: the
flat argument (parallel/sharded_search.py) applied twice.
"""

from __future__ import annotations

import torch

from rust_local_rag_tpu_torch.parallel.mesh import Mesh
from rust_local_rag_tpu_torch.parallel.sharded_search import _Layout, sharded_exact_topk

NEG_INF = float("-inf")


def multislice_topk(queries, corpus, k: int, mesh: Mesh, slice_axis: str = "slice", ici_axis: str = "ici",
                    valid_count=None):
    """Exact top-k with the corpus row-sharded over both mesh axes; rows
    at or past valid_count are masked -> (values [Q, k] f32, global
    indices [Q, k] int32) on the lead device, index -1 at every -inf
    value (fewer live rows than k). Needs N divisible by the shard count
    and k <= N / shards."""
    lay = _Layout(mesh, (slice_axis, ici_axis), None, corpus.shape[0],
                  "corpus rows {n} must divide evenly across {s} shards")
    vals, idx = sharded_exact_topk(lay, queries, corpus, k, valid_count)
    # a -inf value's index is an arbitrary masked row: never to be gathered
    return vals, torch.where(vals == NEG_INF, -1, idx).to(torch.int32)
