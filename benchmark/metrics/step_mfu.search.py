"""Model operations of the requests answered within the window (the dense
scores, the query encoder and the judge at their unpadded tokens) / (the
window's seconds x 989 TFLOP/s)."""

from harness import work


def read(rec):
    return 100.0 * rec.flops / (rec.window_s * work.BF16_FLOPS) if rec.flops > 0 else None
