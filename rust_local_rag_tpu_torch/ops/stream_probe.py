"""The streaming score + segment-max kernel and its read and dot probes: the
CUDA kernels of csrc/stream_probe.cu (K2, K3) and csrc/resident_dot.cu (K4)
and their plain PyTorch versions.

Ports of the TPU kernels of the exact top-k experiments (bf16 queries
[Q, D] and slab [N, D], f32 scores, segments of 64 or 128 rows):

  stream_segmax         make_stream (scripts/exp_stream_kernel.py:27-119)
                        and the "both" mode of make
                        (scripts/exp_isolate_kernel.py:34-99,
                        scripts/exp_isolate2.py:17-79): segmax [N/seg, Q]
                        of the scores, with the scores as [Q, N], [N, Q]
                        or not at all;
  resident_dot_segmax   the "dot" mode of the same makes: corpus block 0
                        (blk rows) scored again for every chunk, so its
                        segment maxima repeat down the [N/128, Q] output
                        (every chunk's product is computed: the probe
                        times the tensor cores);
  read_probe            the "dma" modes and make
                        (scripts/exp_dma_probe.py:19-64): stream the slab,
                        keep the first `width` values of each chunk's
                        first row (the part of the TPU's output that is
                        defined) and, so that every byte's read shows, the
                        int64 sum of each chunk's bf16 bit patterns as
                        int16.

Each wrapper launches its kernel for CUDA tensors and runs the plain
version only for CPU tensors; there is no fallback from one to the other.
The TPU kernels' knobs (slots, static, natural) are carried to the card as
the two sources say; none changes the result.
"""

from __future__ import annotations

import torch

from rust_local_rag_tpu_torch.kernels import build

TILE = 128      # corpus rows a kernel block; the most queries a launch takes
DEPTH = 64      # D must be a multiple of it on the card
ROW_BLOCK = 65536  # slab rows the plain versions widen to f32 at a time
LAYOUTS = {"none": 0, "qn": 1, "nq": 2}
# K4 keeps a block's 64-query half (D x 128 bytes) in shared memory beside
# a ring of at least two 16 KB stages (csrc/resident_dot.cu)
RESIDENT_MAX_D = 1472
RESIDENT_QUERIES = 64   # queries a K4 block holds
RESIDENT_CHUNKS = 4     # chunks a K4 row tile fetched from L2 feeds


def scores_f32(queries: torch.Tensor, corpus: torch.Tensor, rows: int = ROW_BLOCK) -> torch.Tensor:
    """[Q, D] x [N, D] -> [Q, N] f32 scores in full f32: the operands are
    widened to f32 (exact for bf16) a block of `rows` slab rows at a time."""
    qf = queries.float()
    out = torch.empty((queries.shape[0], corpus.shape[0]), dtype=torch.float32, device=corpus.device)
    for lo in range(0, corpus.shape[0], rows):
        out[:, lo:lo + rows] = qf @ corpus[lo:lo + rows].float().T
    return out


def stream_segmax_plain(queries: torch.Tensor, corpus: torch.Tensor, seg: int = 128, layout: str = "qn"):
    """-> (scores [Q, N] (qn), [N, Q] (nq) or None (none), segmax [N/seg, Q])."""
    scores = scores_f32(queries, corpus)
    q, n = scores.shape
    sm = scores.view(q, n // seg, seg).amax(dim=2).T.contiguous()
    if layout == "none":
        return None, sm
    return (scores if layout == "qn" else scores.T.contiguous()), sm


def resident_dot_plain(queries: torch.Tensor, corpus: torch.Tensor, blk: int) -> torch.Tensor:
    """-> [N/128, Q]: block 0's segment maxima repeated for each of the
    N/blk chunks."""
    _, sm = stream_segmax_plain(queries, corpus[:blk], 128, "none")
    return sm.repeat(corpus.shape[0] // blk, 1)


def read_probe_plain(corpus: torch.Tensor, blk: int, width: int = 128):
    """-> (heads [N/blk, width] f32: the first `width` values of each
    chunk's first row, sums [N/blk] int64: each chunk's bf16 bit patterns
    summed as int16)."""
    n, d = corpus.shape
    heads = corpus[::blk, :width].float()
    sums = corpus.view(torch.int16).reshape(n // blk, blk * d).sum(dim=1, dtype=torch.int64)
    return heads, sums


def _check(queries, corpus, what: str) -> None:
    tensors = (corpus,) if queries is None else (queries, corpus)
    if any(t.device != corpus.device for t in tensors):
        raise ValueError(f"{what}: tensors on different devices ({[str(t.device) for t in tensors]})")
    if any(t.dim() != 2 or t.dtype != torch.bfloat16 for t in tensors):
        raise ValueError(f"{what}: expects bfloat16 [Q, D] queries and [N, D] corpus, got "
                         f"{[(tuple(t.shape), t.dtype) for t in tensors]}")
    if queries is not None and queries.shape[1] != corpus.shape[1]:
        raise ValueError(f"{what}: depths differ ({queries.shape[1]} and {corpus.shape[1]})")
    if corpus.device.type == "cuda":
        for t in tensors:
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError(f"{what}: tensors must be contiguous and 16-byte aligned")
    elif corpus.device.type != "cpu":
        raise ValueError(f"{what}: unsupported device {corpus.device}")


def _check_stream(queries, corpus, seg: int, slots: int, what: str) -> None:
    _check(queries, corpus, what)
    (q, d), n = queries.shape, corpus.shape[0]
    if seg not in (64, 128) or n % TILE or slots < 1:
        raise ValueError(f"{what}: needs seg 64 or 128, N % {TILE} == 0 and slots >= 1 (seg={seg}, N={n})")
    if corpus.device.type == "cuda" and not (1 <= q <= TILE and d % DEPTH == 0):
        raise ValueError(f"{what}: the kernel takes 1 <= Q <= {TILE} and D % {DEPTH} == 0 (Q={q}, D={d})")


def _raise(error_string, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: {error_string(err).decode()} ({err})")


def _stages(slots: int) -> int:
    """The TPU's DMA ring depth -> the kernel's cp.async stages (2 or 4)."""
    return 2 if slots <= 2 else 4


def stream_segmax(queries: torch.Tensor, corpus: torch.Tensor, seg: int = 128, layout: str = "qn",
                  natural: bool = False, slots: int = 2):
    """queries [Q, D] bf16, corpus [N, D] bf16 -> (scores [Q, N] f32 (layout
    "qn"), [N, Q] ("nq") or None ("none"), segmax [N/seg, Q] f32).

    CUDA tensors launch the kernel (counted in ``stream_segmax.launches``);
    CPU tensors take stream_segmax_plain."""
    if layout not in LAYOUTS:
        raise ValueError(f"stream_segmax: layout must be one of {sorted(LAYOUTS)}, got {layout!r}")
    _check_stream(queries, corpus, seg, slots, "stream_segmax")
    dev = corpus.device
    if dev.type == "cpu":
        return stream_segmax_plain(queries, corpus, seg, layout)
    lib = build.load("stream_probe")
    (q, d), n = queries.shape, corpus.shape[0]
    shape = {"none": None, "qn": (q, n), "nq": (n, q)}[layout]
    scores = None if shape is None else torch.empty(shape, dtype=torch.float32, device=dev)
    sm = torch.empty((n // seg, q), dtype=torch.float32, device=dev)
    err = lib.stream_segmax(queries.data_ptr(), corpus.data_ptr(), 0 if scores is None else scores.data_ptr(),
                            sm.data_ptr(), q, n, d, seg, LAYOUTS[layout], int(natural), _stages(slots),
                            dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _raise(lib.stream_probe_error_string, err, "stream_segmax")
    stream_segmax.launches += 1
    return scores, sm


stream_segmax.launches = 0


def resident_dot_limits(q: int, d: int) -> None:
    """Raise ValueError unless K4's kernel takes Q queries of depth D."""
    if not (1 <= q <= TILE and d % DEPTH == 0 and DEPTH <= d <= RESIDENT_MAX_D):
        raise ValueError(f"resident_dot_segmax: the kernel takes 1 <= Q <= {TILE} and D a multiple of {DEPTH} "
                         f"up to {RESIDENT_MAX_D} (its 64-query half beside a two-stage ring in shared "
                         f"memory) (Q={q}, D={d})")


def resident_dot_feed_bytes(q: int, n: int, d: int, blk: int, sms: int) -> int:
    """Bytes K4's launch copies from L2 into shared memory: each unit (a
    query half, a 128-row tile of block 0, RESIDENT_CHUNKS chunks) streams
    the tile's 128 D 2 bytes once, and each of the `sms` blocks (at most
    one a unit) loads its 64-query half once."""
    halves = -(-q // RESIDENT_QUERIES)
    units = (blk // TILE) * -(-(n // blk) // RESIDENT_CHUNKS)
    blocks = min(sms // halves, units) * halves
    return halves * units * TILE * d * 2 + blocks * RESIDENT_QUERIES * d * 2


def resident_dot_segmax(queries: torch.Tensor, corpus: torch.Tensor, blk: int, natural: bool = False,
                        slots: int = 2) -> torch.Tensor:
    """queries [Q, D] bf16, corpus [N, D] bf16 -> [N/128, Q] f32: the
    segment maxima of corpus block 0 (its first blk rows) against the
    queries, repeated for each of the N/blk chunks, each chunk's from its
    own product. On the card D <= RESIDENT_MAX_D.

    CUDA tensors launch the kernel (counted in
    ``resident_dot_segmax.launches``); CPU tensors take resident_dot_plain."""
    _check_stream(queries, corpus, 128, slots, "resident_dot_segmax")
    n = corpus.shape[0]
    if blk < TILE or blk % TILE or n % blk:
        raise ValueError(f"resident_dot_segmax: blk must be a multiple of {TILE} that divides N (blk={blk}, N={n})")
    dev = corpus.device
    if dev.type == "cpu":
        return resident_dot_plain(queries, corpus, blk)
    q, d = queries.shape
    resident_dot_limits(q, d)
    lib = build.load("resident_dot")
    sm = torch.empty((n // TILE, q), dtype=torch.float32, device=dev)
    err = lib.resident_dot_segmax(queries.data_ptr(), corpus.data_ptr(), sm.data_ptr(), q, n, d, blk,
                                  int(natural), slots, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _raise(lib.resident_dot_error_string, err, "resident_dot_segmax")
    resident_dot_segmax.launches += 1
    return sm


resident_dot_segmax.launches = 0


def _probe_loads(slots: int, chunk_bytes: int) -> int:
    """16-byte loads a thread a block: the largest power of two <= slots
    (at most 16) whose 4,096-byte multiple divides a chunk; 0 if none."""
    u = 16
    while u > 1 and (u > slots or chunk_bytes % (4096 * u)):
        u //= 2
    return u if chunk_bytes % 4096 == 0 else 0


def read_probe(corpus: torch.Tensor, blk: int, width: int = 128, slots: int = 2, static: bool = True):
    """corpus [N, D] bf16 -> (heads [N/blk, width] f32, sums [N/blk] int64),
    as read_probe_plain.

    CUDA tensors launch the kernel (counted in ``read_probe.launches``);
    CPU tensors take read_probe_plain."""
    _check(None, corpus, "read_probe")
    n, d = corpus.shape
    if blk < 1 or n % blk or not 1 <= width <= d or slots < 1:
        raise ValueError(f"read_probe: needs N % blk == 0, 1 <= width <= D, slots >= 1 "
                         f"(N={n}, blk={blk}, width={width}, slots={slots})")
    dev = corpus.device
    if dev.type == "cpu":
        return read_probe_plain(corpus, blk, width)
    u = _probe_loads(slots, blk * d * 2)
    if not u:
        raise ValueError(f"read_probe: a chunk's {blk * d * 2} bytes are not a multiple of 4,096")
    lib = build.load("stream_probe")
    heads = torch.empty((n // blk, width), dtype=torch.float32, device=dev)
    sums = torch.zeros((n // blk,), dtype=torch.int64, device=dev)
    err = lib.read_probe(corpus.data_ptr(), heads.data_ptr(), sums.data_ptr(), n, d, blk, width, u,
                         int(static), dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _raise(lib.stream_probe_error_string, err, "read_probe")
    read_probe.launches += 1
    return heads, sums


read_probe.launches = 0
