"""The attention kernel's share of its roofline in the profiled
sub-window: each encoder batch (EmbeddingService.embed_texts) recorded
there is `depth` launches over its texts' valid lengths
(harness.work.attention_bound); the mean least time of a launch times the
attention kernels the trace holds, over their device time."""

from harness import trace, work

KERNELS = ("attention_kernel", "attention_wgmma")


def _batch(a, kw, roots):
    enc = roots["encoder_cfg"]
    lengths = [roots["tokens_of"](t) for t in a[0]]
    bound = work.attention_bound(enc["heads"], enc["dim"] // enc["heads"], lengths)
    return {"launches": enc["depth"], "bound": enc["depth"] * bound}


PROBES = [{"kind": "record", "name": "encoder_batches", "target": "service.embed_texts", "fn": _batch}]


def read(rec):
    batches = rec.probes.records.get("encoder_batches", [])
    if rec.trace is None or not batches:
        return None
    events = trace.kernels(rec.trace, KERNELS)
    us = sum(float(e.get("dur", 0.0)) for e in events)
    if not events or us <= 0:
        return None
    mean = sum(b["bound"] for b in batches) / sum(b["launches"] for b in batches)
    return 100.0 * mean * len(events) / (us / 1e6)
