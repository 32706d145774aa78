"""Host milliseconds a chunk in the encoder's tokenising and padding
(the program's span encoder.tokenize in
TransformerEncoderModel._forward_padded), outside the profiled
sub-window."""

from harness import spans

PROBES = [spans.hook("service.embed_in_batches")]


def read(rec):
    return spans.ms_per_item(rec, "encoder.tokenize")
