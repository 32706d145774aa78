"""Device ops of the port: exact top-k selection, the masked score +
segment-max kernel, and the hybrid dense + BM25 first stage; the exact
top-k experiments' kernels (segmax, stream_probe)."""
