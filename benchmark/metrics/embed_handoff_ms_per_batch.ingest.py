"""Host milliseconds an encoder batch in the hand-off to and from the
embed-batch worker thread (the program's interval embed.handoff: submit to
the worker's start, plus the worker's end to the caller's resumption),
outside the profiled sub-window."""

from harness import spans

PROBES = [spans.hook("service.embed_in_batches")]


def read(rec):
    return spans.ms_per_call(rec, "embed.handoff")
