"""How the SSD chunk kernel picks its route and groups a chunk's heads into
blocks, both from host shapes alone (``repro_torch.kernels.ssd_chunk.ops``):
the card's kernels follow these plain functions, so the CPU checks them.

Routes: Q 32, 64 or 128 at head dim 64 and state 128 (every mamba2 size)
go to the tensor cores, every other shape to the CUDA cores.  Head groups:
a tensor-core block computes C·Bᵀ once for G heads of one chunk; G is the
fewest heads that fit all blocks into one wave of the card's SMs (all
heads when none does), and every (batch, chunk, head) falls in exactly one
block, also when G does not divide the head count."""
import pytest

from repro_torch.kernels.ssd_chunk.ops import (
    CUDA_CORES,
    TENSOR_CORES,
    plan_head_groups,
    ssd_route,
)

H100_SMS = 132


def block_heads(b, nc, h, g):
    """The (batch, chunk, heads) of each tensor-core block in grid order,
    as ``ssd_chunk_mma_kernel`` computes them from ``blockIdx.x``."""
    groups = -(-h // g)
    out = []
    for blk in range(b * nc * groups):
        bn, h0 = divmod(blk, groups)
        h0 *= g
        out.append((bn // nc, bn % nc, range(h0, min(h0 + g, h))))
    return out

# (Q, hd, ds) -> route: mamba2-130m's chunk, Q 128, then the JAX package's
# test shapes (tests/test_ssd_kernel.py) and the edges
ROUTES = {
    "mamba2_chunk_64": ((64, 64, 128), TENSOR_CORES),
    "chunk_128": ((128, 64, 128), TENSOR_CORES),
    "chunk_32": ((32, 64, 128), TENSOR_CORES),
    "jax_q8_ds8": ((8, 16, 8), CUDA_CORES),
    "jax_q16_ds16": ((16, 32, 16), CUDA_CORES),
    "jax_ds16": ((64, 64, 16), CUDA_CORES),
    "chunk_96": ((96, 64, 128), CUDA_CORES),
    "head_dim_128": ((64, 128, 128), CUDA_CORES),
    "state_64": ((64, 64, 64), CUDA_CORES),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_ssd_route(name):
    shape, route = ROUTES[name]
    assert ssd_route(*shape) == route


# (B, NC, H) -> (G, blocks) on an H100's 132 SMs: mamba2-130m's live
# prefill (1,298-1,321 tokens, 21 chunks of 64, 24 heads), the 333-token
# request (6 chunks), a long prompt, and one chunk
PLANS = {
    "live_21_chunks": ((1, 21, 24), (4, 126)),
    "text_333_tokens": ((1, 6, 24), (2, 72)),
    "long_200_chunks": ((1, 200, 24), (24, 200)),
    "one_chunk": ((1, 1, 24), (1, 24)),
    "batch_4_of_21": ((4, 21, 24), (24, 84)),
    "heads_not_divisible": ((1, 40, 7), (3, 120)),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_plan_head_groups(name):
    (b, nc, h), (g, blocks) = PLANS[name]
    assert plan_head_groups(b, nc, h, H100_SMS) == g
    assert len(block_heads(b, nc, h, g)) == blocks


@pytest.mark.parametrize("b,nc,h,g", [(1, 21, 24, 4), (1, 6, 24, 2),
                                      (2, 3, 7, 3), (1, 40, 7, 4),
                                      (3, 2, 5, 5), (1, 4, 24, 24),
                                      (2, 5, 1, 1)])
def test_every_chunk_head_in_one_block(b, nc, h, g):
    seen = {}
    for blk, (bi, n, heads) in enumerate(block_heads(b, nc, h, g)):
        assert 1 <= len(heads) <= g
        for hh in heads:
            assert (bi, n, hh) not in seen, (blk, seen.get((bi, n, hh)))
            seen[(bi, n, hh)] = blk
    assert sorted(seen) == [(bi, n, hh) for bi in range(b)
                            for n in range(nc) for hh in range(h)]


@pytest.mark.parametrize("sms", [66, 114, 132])
def test_plan_fills_one_wave_with_the_fewest_heads(sms):
    """On any SM count, G is the smallest group whose grid fits one wave
    (or all heads when none does)."""
    for b, nc, h in [(1, 21, 24), (1, 6, 24), (2, 9, 7), (1, 130, 24)]:
        g = plan_head_groups(b, nc, h, sms)
        blocks = len(block_heads(b, nc, h, g))
        assert blocks <= sms or g == h
        if g > 1:
            assert len(block_heads(b, nc, h, g - 1)) > sms
