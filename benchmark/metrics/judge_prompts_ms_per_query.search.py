"""Host milliseconds a judged query in building its judge prompts (the
program's span judge.prompts in RerankerService.build_prompts), outside
the profiled sub-window."""

from harness import spans

PROBES = [spans.hook("service.get_query_embeddings_device")]


def read(rec):
    return spans.ms_per_item(rec, "judge.prompts")
