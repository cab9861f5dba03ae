"""The port's four CUDA kernels against their plain versions, on the card.

Skips without a card.  On a machine with one (and no JAX), run::

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Shapes: MHA and GQA (group 4), window 0 and 64, Dh 128, page size 16, a
page table padded with a scratch page, a ragged query count and an idle
row (``lengths == 0``, whose decode output must be zeros; the plain version
gives the uniform mean there, so the comparison skips it).  Tolerance, per
element (``repro_torch.kernels.check``): fp32 outputs 1e-4 (sum order);
bf16 outputs one bf16 ulp of the larger of the two values plus
``2**-17 * max|V|`` (two roundings of fp32 sums taken in another order).
"""
import pytest
import torch

from repro_torch.kernels import KERNELS
from repro_torch.kernels.check import compare, v_absmax
from repro_torch.kernels.paged_attn.ops import paged_attention
from repro_torch.kernels.paged_attn.ref import paged_attention_ref
from repro_torch.kernels.selective_attn.ops import selective_attention_paged
from repro_torch.kernels.selective_attn.ref import (
    selective_attention_paged_ref,
)

pytestmark = pytest.mark.cuda
PS, P, DH = 16, 96, 128
LENGTHS = [0, 77, 700]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(dev, hkv, pool, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (P, PS, hkv, DH)
    if pool == "int8":
        k = torch.randint(-127, 128, shape, generator=g, device=dev,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=g, device=dev,
                          dtype=torch.int8)
        ks = torch.rand((P, hkv), generator=g, device=dev) * 0.02 + 1e-3
        vs = torch.rand((P, hkv), generator=g, device=dev) * 0.02 + 1e-3
    else:
        dt = getattr(torch, pool)
        k = torch.randn(shape, generator=g, device=dev).to(dt)
        v = torch.randn(shape, generator=g, device=dev).to(dt)
        ks = vs = None
    perm = torch.randperm(P - 1, generator=g, device=dev) + 1
    pt = torch.zeros((len(LENGTHS), 48), dtype=torch.int32, device=dev)
    used = 0
    for i, n in enumerate(LENGTHS):
        npg = -(-n // PS)
        pt[i, :npg] = perm[used:used + npg]
        used += npg
    lens = torch.tensor(LENGTHS, dtype=torch.int32, device=dev)
    return k, v, ks, vs, pt, lens, g


CASES = pytest.mark.parametrize("pool,qdt", [
    ("float32", torch.float32), ("bfloat16", torch.bfloat16),
    ("int8", torch.float32), ("int8", torch.bfloat16)])
HEADS = pytest.mark.parametrize("hq,hkv", [(8, 8), (32, 8)],
                                ids=["mha", "gqa4"])
WINDOWS = pytest.mark.parametrize("window", [0, 64])


@CASES
@HEADS
@WINDOWS
def test_paged_decode_kernel(dev, pool, qdt, hq, hkv, window):
    k, v, ks, vs, pt, lens, g = _inputs(dev, hkv, pool, seed=1)
    q = torch.randn((len(LENGTHS), hq, DH), generator=g, device=dev).to(qdt)
    kern = KERNELS["paged_attn_q8" if ks is not None else "paged_attn"]
    before = kern.launches
    out = paged_attention(q, k, v, pt, lens, k_scale=ks, v_scale=vs,
                          window=window)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    ref = paged_attention_ref(q, k, v, pt, lens, ks, vs, window=window)
    assert torch.all(out[0] == 0)
    res = compare(out, ref, v_absmax(v, vs), rows=lens > 0)
    assert res["worst"] <= 1.0, res


@CASES
@HEADS
@WINDOWS
def test_selective_prefill_kernel(dev, pool, qdt, hq, hkv, window):
    k, v, ks, vs, pt, lens, g = _inputs(dev, hkv, pool, seed=2)
    sq = 37
    q = torch.randn((len(LENGTHS), sq, hq, DH), generator=g,
                    device=dev).to(qdt)
    q_pos = torch.stack([
        torch.sort(torch.randperm(max(n, sq), generator=g, device=dev)[:sq])[0]
        for n in LENGTHS]).to(torch.int32)
    kern = KERNELS["sel_attn_paged_q8" if ks is not None else "sel_attn_paged"]
    before = kern.launches
    out = selective_attention_paged(q, k, v, pt, q_pos, lens, k_scale=ks,
                                    v_scale=vs, window=window)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    ref = selective_attention_paged_ref(q.transpose(1, 2), k, v, pt, q_pos,
                                        lens, ks, vs,
                                        window=window).transpose(1, 2)
    res = compare(out, ref, v_absmax(v, vs))
    assert res["worst"] <= 1.0, res


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    k, v, ks, vs, pt, lens, g = _inputs(dev, 8, "float32", seed=3)
    q = torch.randn((len(LENGTHS), 8, DH), device=dev)
    with pytest.raises(ValueError):
        paged_attention(q.half(), k, v, pt, lens)                # dtype
    with pytest.raises(ValueError):
        paged_attention(q, k, v, pt.long(), lens)                # index dtype
    with pytest.raises(ValueError):
        paged_attention(q, k.transpose(0, 1), v, pt, lens)       # layout
