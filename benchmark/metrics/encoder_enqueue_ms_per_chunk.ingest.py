"""Host milliseconds a chunk in the encoder's eager forward, the launches
enqueued and not waited for (the program's span encoder.forward),
outside the profiled sub-window."""

from harness import spans

PROBES = [spans.hook("service.embed_in_batches")]


def read(rec):
    return spans.ms_per_item(rec, "encoder.forward")
