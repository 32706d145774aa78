"""The encoder's operations for the chunks indexed within the window, at
their unpadded tokens / (the window's seconds x 989 TFLOP/s)."""

from harness import work


def read(rec):
    return 100.0 * rec.flops / (rec.window_s * work.BF16_FLOPS) if rec.flops > 0 else None
