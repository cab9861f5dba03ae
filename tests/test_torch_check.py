"""The bf16 tolerance that holds the CUDA kernels to their plain versions
(``repro_torch.kernels.check``), exercised on the CPU at the decode shape
of the main path: four sequences of 1.3k-1.9k keys, N(0,1) K/V as the
seeded model gives at layer 0, bf16 q, bf16 or int8 pool.

A stand-in for a correct kernel (the plain version with the full pages of
each row visited in reverse order: the same keys, summed in another order)
must pass.  Stand-ins for a kernel that drops the newest key, the ragged
last page or a few pages' K scales must fail it.
"""
import math

import pytest
import torch

from repro_torch.kernels.check import compare, v_absmax
from repro_torch.kernels.paged_attn.ref import paged_attention_ref

PS, HKV, HQ, DH = 16, 8, 8, 128
LENGTHS = [1302, 1497, 1650, 1889]


def _decode_inputs(pool):
    g = torch.Generator().manual_seed(0)
    mp = max(-(-n // PS) for n in LENGTHS)
    p = 1 + len(LENGTHS) * mp
    k = torch.randn((p, PS, HKV, DH), generator=g)
    v = torch.randn((p, PS, HKV, DH), generator=g)
    if pool == "int8":
        ks = k.abs().amax(dim=(1, 3)) / 127
        vs = v.abs().amax(dim=(1, 3)) / 127
        k = torch.round(k / ks[:, None, :, None]).to(torch.int8)
        v = torch.round(v / vs[:, None, :, None]).to(torch.int8)
    else:
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
        ks = vs = None
    pt = torch.zeros((len(LENGTHS), mp), dtype=torch.int32)
    perm = torch.randperm(p - 1, generator=g) + 1
    for i, n in enumerate(LENGTHS):
        npg = -(-n // PS)
        pt[i, :npg] = perm[i * mp:i * mp + npg]
    q = torch.randn((len(LENGTHS), HQ, DH), generator=g).to(torch.bfloat16)
    lens = torch.tensor(LENGTHS, dtype=torch.int32)
    return q, k, v, ks, vs, pt, lens


def _stand_in(mutation, q, k, v, ks, vs, pt, lens):
    """What a kernel with the given fault would return."""
    pt, lens = pt.clone(), lens.clone()
    if ks is not None:
        ks = ks.clone()
    if mutation == "reordered":              # correct: another sum order
        for i, n in enumerate(lens.tolist()):
            full = n // PS
            pt[i, :full] = pt[i, :full].flip(0)
    elif mutation == "newest_key":
        lens -= 1
    elif mutation == "ragged_page":
        lens = lens // PS * PS
    elif mutation == "k_scales":             # three pages take a neighbour's
        for i in range(3):
            page = int(pt[i, 5 + 20 * i])
            ks[page] = ks[page + 1]
    return paged_attention_ref(q, k, v, pt, lens, ks, vs)


@pytest.mark.parametrize("pool,mutation", [
    (pool, m) for pool in ("bf16", "int8")
    for m in ("reordered", "newest_key", "ragged_page")] + [
    ("int8", "k_scales")])                   # K scales: int8 pool only
def test_bf16_limit_separates_faults_from_rounding(pool, mutation):
    q, k, v, ks, vs, pt, lens = _decode_inputs(pool)
    ref = paged_attention_ref(q, k, v, pt, lens, ks, vs)
    out = _stand_in(mutation, q, k, v, ks, vs, pt, lens)
    assert out.dtype == torch.bfloat16
    res = compare(out, ref, v_absmax(v, vs))
    assert math.isfinite(res["worst"])
    if mutation == "reordered":
        assert res["worst"] <= 1.0, res
    else:
        assert res["worst"] > 1.0, res


def test_fp32_limit_and_row_mask():
    a = torch.zeros((3, 4))
    b = a.clone()
    b[0] = 1.0                               # an excluded row may differ
    b[1, 0] = 5e-5
    res = compare(a, b, 1.0, rows=torch.tensor([False, True, True]))
    assert res["max_abs_err"] == pytest.approx(5e-5)
    assert res["worst"] == pytest.approx(0.5)
