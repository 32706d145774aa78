"""K4, the resident dot probe (ops/stream_probe.resident_dot_segmax; on the
card csrc/resident_dot.cu), against the scripts' own Pallas "dot" mode
(scripts/exp_isolate2.py and scripts/exp_isolate_kernel.py, make) in
interpret mode, on the same seeded inputs.

The scripts are loaded by path with their shape globals set small and
their pallas_call in interpret mode, by tests/test_torch_experiments.py's
loader; scripts/ is not edited. The port's side runs on CPU tensors, so
the wrapper takes the plain version (chip_smoke.py holds the kernel to it
on the card). The cases sit at the kernel's tile edges: Q 1, 17 (inside a
64-query half), 64 (one half, full), 128 (two halves); blk 128 (one row
tile, a unit of four chunks per tile), 256 and 2,048; D 64 (one stage a
product) and 128 (two).

Tolerance: SCORE_ATOL, since both sides sum the same D exact bf16 products
in f32, in another order (XLA's CPU dot against torch's); |error| <= D eps
sum|terms|, below 2e-4 at D <= 128 with standard-normal inputs, and a
segment's max moves by no more than its largest score's error.
"""

import numpy as np
import pytest
import torch
from test_torch_experiments import SCORE_ATOL, bf16, load_script

from rust_local_rag_tpu_torch.experiments import isolate2, isolate_kernel
from rust_local_rag_tpu_torch.ops.stream_probe import (
    RESIDENT_MAX_D,
    resident_dot_feed_bytes,
    resident_dot_limits,
    resident_dot_plain,
    resident_dot_segmax,
)


def inputs(seed: int, q: int, n: int, d: int):
    """(torch, jnp) bf16 queries [q, d], then corpus [n, d], standard normal."""
    rng = np.random.default_rng(seed)
    return (*bf16(rng, (q, d)), *bf16(rng, (n, d)))


def chunks_identical(out: torch.Tensor, blk: int) -> bool:
    per = blk // 128
    return torch.equal(out, out[:per].repeat(out.shape[0] // per, 1))


def n_for(blk: int) -> int:
    """Four chunks at least, eight of a one-tile block."""
    return max(4 * blk, 1024)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("natural", [False, True], ids=["qd", "natural"])
@pytest.mark.parametrize("blk", [128, 256, 2048])
@pytest.mark.parametrize("q", [1, 17, 64, 128])
def test_resident_dot_matches_exp_isolate2_dot(q, blk, natural, d):
    n = n_for(blk)
    jm = load_script("isolate2", N=n, D=d, Q=q)
    qt, qj, ct, cj = inputs(1000 * q + blk + d + natural, q, n, d)
    want = np.array(jm.make("dot", blk, natural)(qj, cj))
    got = resident_dot_segmax(qt, ct, blk, natural)
    assert got.shape == want.shape == (n // 128, q) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SCORE_ATOL)
    assert chunks_identical(got, blk)
    assert chunks_identical(torch.from_numpy(want), blk)
    # the same function through the experiment module's make
    torch.testing.assert_close(isolate2.make("dot", blk, natural)(qt, ct), got, rtol=0, atol=0)


@pytest.mark.parametrize("q", [1, 17, 64, 128])
def test_resident_dot_matches_exp_isolate_kernel_dot(q):
    """The first round's script: BLK 2,048, the queries leading."""
    n, d, blk = 8192, 64, 2048
    jm = load_script("isolate_kernel", N=n, D=d, Q=q, BLK=blk)
    qt, qj, ct, cj = inputs(q, q, n, d)
    want = np.array(jm.make("dot")(qj, cj))
    got = isolate_kernel.make("dot", 2, blk)(qt, ct)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SCORE_ATOL)
    assert chunks_identical(got, blk)


@pytest.mark.parametrize("slots", [1, 2, 4, 16])
def test_slots_do_not_change_the_result(slots):
    qt, _, ct, _ = inputs(5, 17, 4096, 128)
    torch.testing.assert_close(resident_dot_segmax(qt, ct, 1024, slots=slots), resident_dot_plain(qt, ct, 1024),
                               rtol=0, atol=0)


def test_plain_version_is_block_zeros_segment_maxima_repeated():
    """Only block 0 is read: the rows past it may hold anything."""
    qt, _, ct, _ = inputs(9, 8, 2048, 64)
    blk = 512
    ref = (qt.float() @ ct[:blk].float().T).view(8, blk // 128, 128).amax(dim=2).T
    poisoned = ct.clone()
    poisoned[blk:] = float("nan")
    got = resident_dot_segmax(qt, poisoned, blk)
    torch.testing.assert_close(got, ref.repeat(2048 // blk, 1), rtol=0, atol=0)


@pytest.mark.parametrize("q,d", [(0, 64), (129, 64), (1, 32), (1, 96), (64, RESIDENT_MAX_D + 64), (128, 2048)])
def test_kernel_limits_refuse_what_it_does_not_take(q, d):
    with pytest.raises(ValueError, match="resident_dot_segmax"):
        resident_dot_limits(q, d)


@pytest.mark.parametrize("q,d", [(1, 64), (128, 768), (128, RESIDENT_MAX_D)])
def test_kernel_limits_take_the_experiments_shapes(q, d):
    resident_dot_limits(q, d)


def test_wrapper_refuses_a_bad_block_or_slots():
    qt, _, ct, _ = inputs(3, 4, 1024, 64)
    for blk in (0, 64, 192, 384, 2048):  # not a multiple of 128 dividing N, or past N
        with pytest.raises(ValueError, match="blk"):
            resident_dot_segmax(qt, ct, blk)
    with pytest.raises(ValueError):
        resident_dot_segmax(qt, ct, 256, slots=0)
    with pytest.raises(ValueError):
        resident_dot_segmax(qt.float(), ct, 256)


def test_feed_bytes_count_a_tile_once_a_unit_of_four_chunks():
    """bench.py's shard at Q 128 on 132 SMs: two query halves, each
    streaming block 0's tiles once for every four chunks (N D 2 / 4
    bytes), and each block's 64-query half once."""
    n, d = 1_245_184, 768
    for blk in (2048, 4096, 16384):
        assert resident_dot_feed_bytes(128, n, d, blk, 132) == 2 * n * d * 2 // 4 + 132 * 64 * d * 2
    # Q <= 64 is one half; a fifth chunk takes a unit of its own
    assert resident_dot_feed_bytes(64, 5 * 256, 64, 256, 132) == 2 * 2 * 128 * 64 * 2 + 4 * 64 * 64 * 2
