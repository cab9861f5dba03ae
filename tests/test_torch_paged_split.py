"""The split planner of the paged decode kernel
(``repro_torch.kernels.paged_attn.ops.plan_splits``), which the CUDA
kernel follows: a row's valid keys ``[lo, hi)`` (``lo = max(0, length -
window)``, 0 without a window; ``hi = min(length, mp * ps)``) are cut into
``n_splits`` chunks of 256 keys counted from ``lo``.  Every valid key must
lie in exactly one split, and ``n_splits`` may depend only on shapes the
host knows (the page table's width, the page size, the window), never on
``lengths``, which live on the card."""
import inspect

import pytest

from repro_torch.kernels.paged_attn.ops import CHUNK, plan_splits

# (lengths, page-table width in pages, page size, window)
CASES = {
    "ragged": ([1302, 1497, 1650, 1889, 1, 0], 128, 16, 0),
    "page_and_chunk_multiples": ([16, 256, 512, 768, 2048, 4096], 256, 16,
                                 0),
    "window_mid_chunk": ([1000, 77, 2000, 299, 300, 301, 4096], 256, 16,
                         300),
    "window_small": ([1000, 77, 2000, 5, 0], 256, 16, 100),
    "window_wide": ([1000, 77, 2000, 4096], 256, 16, 1000),
    "table_shorter_than_length": ([5000, 1024, 1025], 64, 16, 0),
    "table_shorter_window": ([5000, 1100, 1024], 64, 16, 2000),
    "page_size_1": ([300, 257, 256], 512, 1, 0),
    "page_size_7": ([300, 257, 700], 128, 7, 130),
}


@pytest.mark.parametrize("case", list(CASES))
def test_every_valid_key_in_exactly_one_split(case):
    lengths, mp, ps, window = CASES[case]
    plan = plan_splits(len(lengths), 8, 128, mp, ps, window)
    for n in lengths:
        lo = max(0, n - window) if window > 0 else 0
        hi = min(n, mp * ps)
        seen = []
        for s in range(plan.n_splits):
            keys = plan.split_keys(n, s)
            assert len(keys) <= CHUNK
            seen.extend(keys)
        assert seen == list(range(lo, hi))          # in order, no overlap
        # nothing is left for a split past the last one
        assert len(plan.split_keys(n, plan.n_splits)) == 0


def test_splits_depend_only_on_host_shapes():
    assert "lengths" not in inspect.signature(plan_splits).parameters
    assert plan_splits(4, 32, 128, 128, 16).n_splits == 8   # llava's decode
    assert plan_splits(1, 32, 128, 128, 16).n_splits == 8
    assert plan_splits(4, 32, 128, 128, 16, window=300).n_splits == 2
    assert plan_splits(4, 32, 128, 128, 16, window=8192).n_splits == 8
    assert plan_splits(4, 32, 128, 0, 16).n_splits == 1     # empty table
    plan = plan_splits(4, 32, 64, 100, 16, window=0)
    assert plan.n_splits == 7                               # 1600 keys
    assert plan.workspace_numel == 4 * 32 * 7 * (64 + 2)
