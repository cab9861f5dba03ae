"""How the dense selective attention (``sel_attn``) picks its route and
plans its splits, both from host shapes alone
(``repro_torch.kernels.selective_attn.ops``): the card's kernels follow
these plain functions, so the CPU checks them.

Routes: bf16 at head dim 64 or 128 goes to the split-key kernel when it has
at most ``SPLIT_MAX_ROWS`` (16) (query, head) rows per (sequence, kv head),
as the dense decode step does, and to the tensor-core kernel otherwise
(uploads, prefills); fp32, and bf16 at any other head dim, go to the
CUDA-core kernel.  Splits: chunks of 256 slots from slot 0, every slot in
exactly one chunk, ``n_splits`` from ``Skv`` alone (never from ``kv_pos``,
which lives on the card; a window bounds positions, not slots)."""
import inspect

import numpy as np
import pytest
import torch

from repro_torch.kernels.selective_attn.ops import (
    CHUNK,
    CUDA_CORES,
    SPLIT_KEYS,
    SPLIT_MAX_ROWS,
    TENSOR_CORES,
    dense_route,
    plan_dense_splits,
)

# (dtype, Dh, Sq, Hq, Hkv) -> route; llava-1.6-7b's four main-path shapes
# first, then the edges
ROUTES = {
    "full_recompute": ((torch.bfloat16, 128, 1298, 32, 32), TENSOR_CORES),
    "dense_mpic": ((torch.bfloat16, 128, 210, 32, 32), TENSOR_CORES),
    "upload": ((torch.bfloat16, 128, 576, 32, 32), TENSOR_CORES),
    "dense_decode": ((torch.bfloat16, 128, 1, 32, 32), SPLIT_KEYS),
    "decode_gqa8_dh64": ((torch.bfloat16, 64, 1, 32, 4), SPLIT_KEYS),
    "boundary_16_rows": ((torch.bfloat16, 128, 4, 32, 8), SPLIT_KEYS),
    "boundary_17_rows": ((torch.bfloat16, 128, 17, 8, 8), TENSOR_CORES),
    "boundary_20_rows": ((torch.bfloat16, 64, 5, 32, 8), TENSOR_CORES),
    "two_queries_mha": ((torch.bfloat16, 128, 2, 8, 8), SPLIT_KEYS),
    "fp32_prefill": ((torch.float32, 128, 1298, 32, 32), CUDA_CORES),
    "fp32_decode": ((torch.float32, 64, 1, 8, 8), CUDA_CORES),
    "bf16_dh32": ((torch.bfloat16, 32, 300, 8, 8), CUDA_CORES),
    "bf16_dh32_decode": ((torch.bfloat16, 32, 1, 8, 8), CUDA_CORES),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_route_by_shape(case):
    (dtype, dh, sq, hq, hkv), want = ROUTES[case]
    assert dense_route(dtype, dh, sq, hq, hkv) == want


def test_route_boundary_is_rows_per_kv_head():
    """The boundary counts (query, head) rows per (sequence, kv head),
    Sq * G, on both sides, for every group size."""
    for g in (1, 2, 4, 8):
        for sq in range(1, 40):
            rows = sq * g
            got = dense_route(torch.bfloat16, 128, sq, 8 * g, 8)
            assert got == (SPLIT_KEYS if rows <= SPLIT_MAX_ROWS
                           else TENSOR_CORES), (g, sq)


def test_route_reads_only_shapes():
    assert list(inspect.signature(dense_route).parameters) == [
        "dtype", "dh", "sq", "hq", "hkv"]
    assert "kv_pos" not in inspect.signature(plan_dense_splits).parameters


@pytest.mark.parametrize("skv", [0, 1, 255, 256, 257, 576, 2047, 2048, 2049])
def test_every_slot_in_exactly_one_chunk(skv):
    plan = plan_dense_splits(4, 1, 32, 128, skv)
    assert plan.n_splits == max(1, -(-skv // CHUNK))
    seen = []
    for s in range(plan.n_splits):
        slots = plan.chunk_slots(s)
        assert len(slots) <= CHUNK
        seen.extend(slots)
    assert seen == list(range(skv))               # in order, no overlap
    assert len(plan.chunk_slots(plan.n_splits)) == 0


def test_plan_independent_of_positions():
    """Two caches of one shape, one full in slot order and one nearly empty
    at shuffled slots, get one plan: the kernel judges each chunk by its
    kv_pos on the card."""
    rng = np.random.default_rng(0)
    kv_full = np.arange(2048, dtype=np.int32)
    kv_sparse = np.full(2048, np.iinfo(np.int32).max, np.int32)
    kv_sparse[rng.permutation(2048)[:40]] = np.arange(40)
    plans = {plan_dense_splits(4, 1, 32, 128, kv.shape[0])
             for kv in (kv_full, kv_sparse)}
    assert len(plans) == 1
    plan = plans.pop()
    assert plan.n_splits == 8                     # llava's 2048-slot cache
    # one partial (acc[Dh], m, l) per (sequence, query, head, split)
    assert plan.workspace_numel == 4 * 1 * 32 * 8 * (128 + 2)
    assert plan_dense_splits(2, 3, 8, 64, 300).workspace_numel == (
        2 * 3 * 8 * 2 * 66)
