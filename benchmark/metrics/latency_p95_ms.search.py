"""The nearest-rank 95th percentile of the latency of every request sent
in the window, at the client. A failed request lies above every latency;
if that puts a failure at the 95th percentile, the window's length stands
for it (the run is then not correct: failed requests have the limit 0)."""

import math

from harness.record import nearest_rank


def read(rec):
    if not rec.latencies_ms:
        return None
    p95 = nearest_rank(rec.latencies_ms, 0.95)
    return p95 if math.isfinite(p95) else rec.window_s * 1e3
