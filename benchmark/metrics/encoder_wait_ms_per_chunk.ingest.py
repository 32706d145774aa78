"""Host milliseconds a chunk in the encoder's read-back, where the host
waits for the device (the program's span encoder.readback around
.cpu() in TransformerEncoderModel.encode), outside the profiled
sub-window."""

from harness import spans

PROBES = [spans.hook("service.embed_in_batches")]


def read(rec):
    return spans.ms_per_item(rec, "encoder.readback")
