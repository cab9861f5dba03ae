"""The port's six CUDA kernels against their plain versions, on the card.

Skips without a card.  On a machine with one (and no JAX), run::

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Shapes: MHA and GQA (group 4), window 0 and 64, Dh 128, page size 16, a
page table padded with a scratch page, a ragged query count and an idle
row (``lengths == 0``, whose decode output must be zeros; the plain version
gives the uniform mean there, so the comparison skips it).  The split-key
decode kernel also runs ``test_paged_decode_kernel_splits``: one row of
2048 keys (8 splits of 256), rows at exact multiples of the split, a page
table much wider than the live pages, a window starting mid-split, Dh 64,
group 8.  Tolerance, per
element (``repro_torch.kernels.check``): fp32 outputs 1e-4 (sum order);
bf16 outputs one bf16 ulp of the larger of the two values plus
``2**-17 * max|V|`` (two roundings of fp32 sums taken in another order).

The bf16 paged prefill runs on the tensor-core kernel, which
``test_selective_prefill_mma_kernel`` drives across its edges: Dh 64 and
128 on both pools, MHA and GQA 32/8, Sq 150 (three or more 64-row tiles
with a ragged last one), lengths 77 and 700 (not multiples of the 64-key
tile), windows that start mid-tile, and the idle length-0 row, whose output
must be all zeros.

The dense selective attention (``sel_attn``) runs on its own synthetic
shape: 32 query heads on 8 kv heads (and MHA), window 64 (and none), Sq 101
and Skv 300 (neither a multiple of a tile), kv positions permuted with
``INVALID_POS`` holes, and one query whose every key is masked (zeros).
Its two bf16 routes (``selective_attn.ops.dense_route``) run across their
edges, each call checked to have counted one launch of its route: the
tensor-core route and the split-key route at head dims 64 and 128, groups
1, 4 and 8, windows 0, 64 and 100, Sq and Skv off every tile multiple (1,
15, 17, 63, 65, 129), slots shuffled with ~10 % ``INVALID_POS``; the
split-key route at the dense decode step's shape (B 4, Sq 1, Skv 2048)
with an idle sequence, a 40-token one (most splits empty), 1302 and 2048
tokens, in slot order and shuffled; the route boundary (16 and 17 rows per
kv head) from both sides; and slot-order invariance on every route.

The SSD chunk kernel (``ssd_chunk``) runs at the four shapes of
``tests/test_ssd_kernel.py``, at mamba2-130m's live prefill (21 chunks of
24 heads) and 333-token request (6 chunks), at Q = ds = 128 (its largest
chunk), with 7 heads in groups of 3 (the last block holds one head), with
``dt = 0`` pad rows, with a large ``dt`` (its masked exponents overflow:
no NaN may leak) and on the model's layout read through permuted views;
each on both routes where the tensor cores take the shape (Q 32/64/128,
hd 64, ds 128; ``ssd_chunk.ops.ssd_route``), each call checked to have
counted one launch of its route.  fp32, held per element to ``1e-4 + 1e-4
* |ref|`` (``repro_torch.kernels.check.ssd_limit``).

The served models' head shapes (``test_*_served_heads``): kernels 1-4 at
qwen2.5-14b's 40 query heads on 8 kv heads (G 5, so the decode kernel's
second tile of a group holds one head and the tensor-core prefill's
64-row blocks split a query's group), yi-9b's 32 on 4 (G 8, the decode
kernel's largest group), phi3-medium-14b's 40 on 10 (G 4) and
stablelm-1.6b's 32 on 32 at head dim 64, granite-moe-1b-a400m's 16 on 8
(G 2) at head dim 64 and deepseek-moe-16b's 16 on 16 at head dim 128, on
every pool and query dtype,
with the decode step's lengths (up to 1889) and a window that bites and
one that does not; kernel 5 at G 5 on its tensor-core route (the upload,
a 64-token chunk, a selective prefill) and its split-key route (the
dense decode step, up to three queries: 15 rows), each call's route
checked, and at the MoE models' heads in an upload and a decode step.  Kernel 5 at hymba-1.5b's 25 query heads on 5 kv heads (G 5,
Dh 64) with its 2048-token window over slots filled in order: an upload,
a long prompt's last 1024 queries in 8192 slots, the banded prefill of 2
windows, and the dense decode step over four 8192-slot rows (the window
biting in the last two); kernel 6 at hymba's SSD heads (25 of 64, state
16) on the CUDA-core route through the model's layout, at 9, 21 and 95
chunks.

The spool-to-pool int8 link (``PagedKVPool.link_write_q8``, plain PyTorch)
runs on the card against the same call on the CPU
(``test_link_write_q8_matches_cpu``; its tolerance is in its docstring).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.cache import PagedConfig, PagedKVPool
from repro_torch.cache.quant import quantize_kv
from repro_torch.core.linker import scale_row_ids
from repro_torch.kernels import KERNELS
from repro_torch.kernels.check import compare, ssd_limit, v_absmax
from repro_torch.kernels.paged_attn.ops import paged_attention
from repro_torch.kernels.paged_attn.ref import paged_attention_ref
from repro_torch.kernels.selective_attn.ops import (
    CUDA_CORES,
    SPLIT_KEYS,
    TENSOR_CORES,
    dense_route,
    selective_attention,
    selective_attention_paged,
)
from repro_torch.kernels.selective_attn.ref import (
    INVALID_POS,
    selective_attention_paged_ref,
    selective_attention_ref,
)
from repro_torch.kernels.ssd_chunk import ops as ssd_ops
from repro_torch.kernels.ssd_chunk.ops import ssd_chunk
from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref

pytestmark = pytest.mark.cuda
PS, P, DH = 16, 96, 128
LENGTHS = [0, 77, 700]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(dev, hkv, pool, seed, dh=DH, lengths=LENGTHS, width=48):
    g = torch.Generator(device=dev).manual_seed(seed)
    npg = [-(-n // PS) for n in lengths]
    p = max(P, 1 + sum(npg))
    shape = (p, PS, hkv, dh)
    if pool == "int8":
        k = torch.randint(-127, 128, shape, generator=g, device=dev,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=g, device=dev,
                          dtype=torch.int8)
        ks = torch.rand((p, hkv), generator=g, device=dev) * 0.02 + 1e-3
        vs = torch.rand((p, hkv), generator=g, device=dev) * 0.02 + 1e-3
    else:
        dt = getattr(torch, pool)
        k = torch.randn(shape, generator=g, device=dev).to(dt)
        v = torch.randn(shape, generator=g, device=dev).to(dt)
        ks = vs = None
    perm = torch.randperm(p - 1, generator=g, device=dev) + 1
    pt = torch.zeros((len(lengths), width), dtype=torch.int32, device=dev)
    used = 0
    for i, n in enumerate(npg):
        pt[i, :n] = perm[used:used + n]
        used += n
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
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


# Split-key edges: (lengths, page-table width in pages, window).  Splits
# are 256 keys counted from a row's first valid key.
SPLIT_SHAPES = {
    "b1_2048": ([2048], 128, 0),                # one row, 8 full splits
    "chunk_multiple": ([0, 512, 256, 300], 32, 0),   # idle, 2 and 1 whole
    "wide_table": ([0, 40, 1000], 128, 0),      # 8 splits, most empty
    "window_mid_chunk": ([1000, 77, 2000], 128, 300),  # lo = 700, 1700
}


@CASES
@pytest.mark.parametrize("dh,hq,hkv", [(128, 8, 1), (64, 8, 2), (64, 4, 4)],
                         ids=["dh128_g8", "dh64_g4", "dh64_mha"])
@pytest.mark.parametrize("shape", list(SPLIT_SHAPES))
def test_paged_decode_kernel_splits(dev, pool, qdt, dh, hq, hkv, shape):
    """The split-key kernel across its edges: a single row of 2048 keys, rows
    at exact multiples of the chunk, a table far wider than the live pages
    (empty splits), a window that starts mid-chunk; Dh 64 and 128, group 8
    (two or four blocks of query heads per kv head) and MHA."""
    lengths, width, window = SPLIT_SHAPES[shape]
    k, v, ks, vs, pt, lens, g = _inputs(dev, hkv, pool, seed=13, dh=dh,
                                        lengths=lengths, width=width)
    q = torch.randn((len(lengths), hq, dh), generator=g, device=dev).to(qdt)
    kern = KERNELS["paged_attn_q8" if ks is not None else "paged_attn"]
    before = kern.launches
    out = paged_attention(q, k, v, pt, lens, k_scale=ks, v_scale=vs,
                          window=window)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    ref = paged_attention_ref(q, k, v, pt, lens, ks, vs, window=window)
    idle = lens == 0
    assert torch.all(out[idle] == 0)
    res = compare(out, ref, v_absmax(v, vs), rows=~idle)
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


@pytest.mark.parametrize("pool", ["bfloat16", "int8"])
@pytest.mark.parametrize("dh", [64, 128])
@HEADS
@pytest.mark.parametrize("window", [0, 64, 100])
def test_selective_prefill_mma_kernel(dev, pool, dh, hq, hkv, window):
    k, v, ks, vs, pt, lens, g = _inputs(dev, hkv, pool, seed=12, dh=dh)
    sq = 150
    q = torch.randn((len(LENGTHS), sq, hq, dh), generator=g,
                    device=dev).to(torch.bfloat16)
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
    assert torch.all(out[0] == 0)              # length 0: no key, zeros
    res = compare(out, ref, v_absmax(v, vs))
    assert res["worst"] <= 1.0, res


def _misaligned(t):
    """A contiguous copy of ``t`` whose data starts 2 bytes past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    view = buf[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    return view


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    k, v, ks, vs, pt, lens, g = _inputs(dev, 8, "float32", seed=3)
    q = torch.randn((len(LENGTHS), 8, DH), device=dev)
    with pytest.raises(ValueError):
        paged_attention(q.half(), k, v, pt, lens)                # dtype
    with pytest.raises(ValueError):
        paged_attention(q, k, v, pt.long(), lens)                # index dtype
    with pytest.raises(ValueError):
        paged_attention(q, k.transpose(0, 1), v, pt, lens)       # layout
    # the decode kernel: head dims 64 and 128, groups up to 8, 16-byte
    # aligned q and pools
    for dh in (32, 96):
        kd, vd, _, _, ptd, lensd, _ = _inputs(dev, 8, "float32", seed=3,
                                              dh=dh)
        with pytest.raises(ValueError, match="head dim"):
            paged_attention(torch.randn((len(LENGTHS), 8, dh), device=dev),
                            kd, vd, ptd, lensd)
    k1, v1, _, _, pt1, lens1, _ = _inputs(dev, 1, "float32", seed=3)
    with pytest.raises(ValueError, match="group"):
        paged_attention(torch.randn((len(LENGTHS), 16, DH), device=dev),
                        k1, v1, pt1, lens1)
    for args in ((_misaligned(q), k, v), (q, _misaligned(k), v),
                 (q, k, _misaligned(v))):
        with pytest.raises(ValueError, match="aligned"):
            paged_attention(*args, pt, lens)
    # the bf16 paged prefill: head dims 64 and 128 only, 16-byte aligned
    q_pos = torch.zeros((len(LENGTHS), 5), dtype=torch.int32, device=dev)
    for dh in (32, 96):
        kb, vb, _, _, ptb, lensb, _ = _inputs(dev, 8, "bfloat16", seed=3,
                                              dh=dh)
        qb = torch.randn((len(LENGTHS), 5, 8, dh), device=dev).bfloat16()
        with pytest.raises(ValueError, match="head dim"):
            selective_attention_paged(qb, kb, vb, ptb, q_pos, lensb)
    kb, vb, _, _, ptb, lensb, _ = _inputs(dev, 8, "bfloat16", seed=3)
    qb = torch.randn((len(LENGTHS), 5, 8, DH), device=dev).bfloat16()
    for args in ((_misaligned(qb), kb, vb), (qb, _misaligned(kb), vb),
                 (qb, kb, _misaligned(vb))):
        with pytest.raises(ValueError, match="aligned"):
            selective_attention_paged(*args, ptb, q_pos, lensb)


def _dense_inputs(dev, dtype, hq, hkv, seed, b=2, sq=101, skv=300):
    """Positions 5..304 in a random order per sequence, ~10% of the slots
    empty; query 0 of sequence 0 sits at position 2, below every key."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, sq, hq, DH), generator=g, device=dev).to(dtype)
    k = torch.randn((b, skv, hkv, DH), generator=g, device=dev).to(dtype)
    v = torch.randn((b, skv, hkv, DH), generator=g, device=dev).to(dtype)
    kv_pos = torch.stack([torch.randperm(skv, generator=g, device=dev) + 5
                          for _ in range(b)]).to(torch.int32)
    holes = torch.rand((b, skv), generator=g, device=dev) < 0.1
    kv_pos[holes] = INVALID_POS
    q_pos = torch.stack([torch.randperm(skv + 10, generator=g,
                                        device=dev)[:sq]
                         for _ in range(b)]).to(torch.int32)
    q_pos[0, 0] = 2
    return q, k, v, q_pos, kv_pos


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@HEADS
@WINDOWS
def test_dense_selective_kernel(dev, dtype, hq, hkv, window):
    q, k, v, q_pos, kv_pos = _dense_inputs(dev, dtype, hq, hkv, seed=4)
    out = _dense_check(q, k, v, q_pos, kv_pos, window)
    assert torch.all(out[0, 0] == 0)           # no visible key: zeros


def _dense_check(q, k, v, q_pos, kv_pos, window, route=None):
    """One launch, counted under ``route`` (the one ``dense_route`` picks
    when None), held per element to the plain version."""
    b, sq, hq, dh = q.shape
    want = dense_route(q.dtype, dh, sq, hq, k.shape[2])
    assert route is None or route == want
    kern = KERNELS["sel_attn"]
    before, before_route = kern.launches, kern.route_launches.get(want, 0)
    out = selective_attention(q, k, v, q_pos, kv_pos, window=window)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    assert kern.route_launches.get(want, 0) == before_route + 1
    ref = selective_attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), q_pos,
        kv_pos, window=window).transpose(1, 2)
    res = compare(out, ref, v_absmax(v))
    assert res["worst"] <= 1.0, res
    return out


def _dense_case(dev, b, sq, skv, hq, hkv, dh, seed):
    """bf16 inputs at any Sq and Skv: positions 5..Skv+4 at shuffled slots,
    ~10 % of the slots empty, queries at random positions below Skv + 10;
    query 0 of sequence 0 sits at position 2, below every key."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).bfloat16()

    kv_pos = torch.stack([torch.randperm(skv, generator=g, device=dev) + 5
                          for _ in range(b)]).to(torch.int32)
    kv_pos[torch.rand((b, skv), generator=g, device=dev) < 0.1] = INVALID_POS
    q_pos = torch.randint(0, skv + 10, (b, sq), generator=g, device=dev,
                          dtype=torch.int32)
    q_pos[0, 0] = 2
    return (randn(b, sq, hq, dh), randn(b, skv, hkv, dh),
            randn(b, skv, hkv, dh), q_pos, kv_pos)


DENSE_DH = pytest.mark.parametrize("dh", [64, 128])
DENSE_WINDOWS = pytest.mark.parametrize("window", [0, 64, 100])


@DENSE_DH
@pytest.mark.parametrize("group", [1, 4, 8])
@DENSE_WINDOWS
@pytest.mark.parametrize("sq,skv", [(17, 1), (63, 15), (65, 17), (129, 63),
                                    (17, 65), (129, 129), (101, 300)])
def test_dense_tensor_core_route(dev, dh, group, window, sq, skv):
    q, k, v, q_pos, kv_pos = _dense_case(dev, 2, sq, skv, 8 * group, 8, dh,
                                         seed=20)
    out = _dense_check(q, k, v, q_pos, kv_pos, window, TENSOR_CORES)
    assert torch.all(out[0, 0] == 0)


@DENSE_DH
@DENSE_WINDOWS
@pytest.mark.parametrize("group,sq", [(1, 1), (1, 15), (4, 1), (4, 4),
                                      (8, 1), (8, 2)])
@pytest.mark.parametrize("skv", [1, 17, 65, 129, 257])
def test_dense_split_route(dev, dh, window, group, sq, skv):
    q, k, v, q_pos, kv_pos = _dense_case(dev, 2, sq, skv, 8 * group, 8, dh,
                                         seed=21)
    out = _dense_check(q, k, v, q_pos, kv_pos, window, SPLIT_KEYS)
    assert torch.all(out[0, 0] == 0)


@DENSE_DH
@pytest.mark.parametrize("hq,hkv", [(32, 32), (32, 8), (32, 4)],
                         ids=["mha", "gqa4", "gqa8"])
@DENSE_WINDOWS
@pytest.mark.parametrize("order", ["in_order", "shuffled"])
def test_dense_decode_route_b4_2048(dev, dh, hq, hkv, window, order):
    """The dense decode step's shape: four slots of 2048, holding 0 (idle:
    every split empty, zeros), 40 (seven of eight splits empty when in
    order), 1302 and 2048 tokens; the query is each slot's newest token."""
    g = torch.Generator(device=dev).manual_seed(22)
    b, skv = 4, 2048
    kv_pos = torch.full((b, skv), INVALID_POS, dtype=torch.int32, device=dev)
    q_pos = torch.zeros((b, 1), dtype=torch.int32, device=dev)
    for i, n in enumerate([0, 40, 1302, 2048]):
        slots = (torch.arange(n, device=dev) if order == "in_order" else
                 torch.randperm(skv, generator=g, device=dev)[:n])
        kv_pos[i, slots] = torch.arange(n, dtype=torch.int32, device=dev)
        q_pos[i] = max(n - 1, 0)
    q = torch.randn((b, 1, hq, dh), generator=g, device=dev).bfloat16()
    k = torch.randn((b, skv, hkv, dh), generator=g, device=dev).bfloat16()
    v = torch.randn((b, skv, hkv, dh), generator=g, device=dev).bfloat16()
    out = _dense_check(q, k, v, q_pos, kv_pos, window, SPLIT_KEYS)
    assert torch.all(out[0] == 0)


@pytest.mark.parametrize("sq,hq,hkv,route", [
    (16, 8, 8, SPLIT_KEYS), (17, 8, 8, TENSOR_CORES),
    (4, 32, 8, SPLIT_KEYS), (5, 32, 8, TENSOR_CORES),
    (2, 32, 4, SPLIT_KEYS), (3, 32, 4, TENSOR_CORES)])
def test_dense_route_boundary(dev, sq, hq, hkv, route):
    q, k, v, q_pos, kv_pos = _dense_case(dev, 2, sq, 300, hq, hkv, DH,
                                         seed=23)
    _dense_check(q, k, v, q_pos, kv_pos, 64, route)


@pytest.mark.parametrize("dtype,sq,route", [
    (torch.float32, 101, CUDA_CORES), (torch.bfloat16, 101, TENSOR_CORES),
    (torch.bfloat16, 1, SPLIT_KEYS)], ids=["fp32", "bf16_mma", "bf16_split"])
def test_dense_kernel_ignores_slot_order(dev, dtype, sq, route):
    """Permuting the KV slots together with kv_pos leaves the output as it
    was, up to the sum order (the position-independence property), on
    every route."""
    q, k, v, q_pos, kv_pos = _dense_inputs(dev, dtype, 32, 8, seed=5, sq=sq)
    assert dense_route(dtype, DH, sq, 32, 8) == route
    perm = torch.randperm(k.shape[1], device=dev)
    a = selective_attention(q, k, v, q_pos, kv_pos, window=64)
    b = selective_attention(q, k[:, perm].contiguous(), v[:, perm].contiguous(),
                            q_pos, kv_pos[:, perm].contiguous(), window=64)
    assert compare(b, a, v_absmax(v))["worst"] <= 1.0


# (Hq, Hkv, Dh) of the GQA/MHA models the engine serves
SERVED = pytest.mark.parametrize("hq,hkv,dh", [
    (40, 8, 128), (32, 4, 128), (40, 10, 128), (32, 32, 64), (16, 8, 64),
    (16, 16, 128)],
    ids=["qwen_g5", "yi_g8", "phi3_g4", "stablelm_mha64", "granite_g2_64",
         "deepseek_mha16"])
SERVED_LENGTHS = [0, 77, 1302, 1889]
SERVED_WINDOWS = pytest.mark.parametrize("window", [0, 300])


@CASES
@SERVED
@SERVED_WINDOWS
def test_paged_decode_served_heads(dev, pool, qdt, hq, hkv, dh, window):
    k, v, ks, vs, pt, lens, g = _inputs(dev, hkv, pool, seed=31, dh=dh,
                                        lengths=SERVED_LENGTHS, width=128)
    q = torch.randn((len(SERVED_LENGTHS), hq, dh), generator=g,
                    device=dev).to(qdt)
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
@SERVED
@SERVED_WINDOWS
def test_selective_prefill_served_heads(dev, pool, qdt, hq, hkv, dh, window):
    """Sq 221 (an mpic selection: at G 5, 1105 rows, so 64-row blocks end
    inside a query's group) against the decode step's lengths."""
    k, v, ks, vs, pt, lens, g = _inputs(dev, hkv, pool, seed=32, dh=dh,
                                        lengths=SERVED_LENGTHS, width=128)
    sq = 221
    q = torch.randn((len(SERVED_LENGTHS), sq, hq, dh), generator=g,
                    device=dev).to(qdt)
    q_pos = torch.stack([
        torch.sort(torch.randperm(max(n, sq), generator=g, device=dev)[:sq])[0]
        for n in SERVED_LENGTHS]).to(torch.int32)
    kern = KERNELS["sel_attn_paged_q8" if ks is not None else "sel_attn_paged"]
    before = kern.launches
    out = selective_attention_paged(q, k, v, pt, q_pos, lens, k_scale=ks,
                                    v_scale=vs, window=window)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    ref = selective_attention_paged_ref(q.transpose(1, 2), k, v, pt, q_pos,
                                        lens, ks, vs,
                                        window=window).transpose(1, 2)
    assert torch.all(out[0] == 0)              # length 0: no key, zeros
    res = compare(out, ref, v_absmax(v, vs))
    assert res["worst"] <= 1.0, res


@pytest.mark.parametrize("b,sq,skv,route", [
    (1, 576, 576, TENSOR_CORES), (1, 64, 2048, TENSOR_CORES),
    (1, 221, 2048, TENSOR_CORES), (2, 4, 300, TENSOR_CORES),
    (4, 1, 2048, SPLIT_KEYS), (2, 3, 300, SPLIT_KEYS)],
    ids=["upload", "chunk", "mpic", "g5_20_rows", "decode", "g5_15_rows"])
@DENSE_WINDOWS
def test_dense_served_g5(dev, b, sq, skv, route, window):
    """Kernel 5 at qwen2.5-14b's G 5 (40 query heads on 8 kv heads, Dh
    128) on both bf16 routes: 5 rows a query, so at most 3 queries take
    the split keys."""
    q, k, v, q_pos, kv_pos = _dense_case(dev, b, sq, skv, 40, 8, DH,
                                         seed=33)
    out = _dense_check(q, k, v, q_pos, kv_pos, window, route)
    assert torch.all(out[0, 0] == 0)


@pytest.mark.parametrize("b,sq,skv,route", [
    (1, 576, 576, TENSOR_CORES), (4, 1, 2048, SPLIT_KEYS)],
    ids=["upload", "decode"])
@pytest.mark.parametrize("hq,hkv,dh", [(16, 8, 64), (16, 16, 128)],
                         ids=["granite_g2_64", "deepseek_mha16"])
def test_dense_served_moe(dev, b, sq, skv, route, hq, hkv, dh):
    """Kernel 5 at the MoE models' heads (granite-moe-1b-a400m's 16 on 8
    at Dh 64, deepseek-moe-16b's 16 on 16 at Dh 128) in an upload and a
    dense decode step, each on its route."""
    q, k, v, q_pos, kv_pos = _dense_case(dev, b, sq, skv, hq, hkv, dh,
                                         seed=36)
    _dense_check(q, k, v, q_pos, kv_pos, 0, route)


# hymba-1.5b's attention: 25 query heads on 5 kv heads (G 5), Dh 64, a
# 2048-token window; (B, Sq, Skv, first query position, route)
HYMBA_DENSE = {
    "upload": (1, 576, 576, 0, TENSOR_CORES),
    "long_prefill": (1, 1024, 8192, 5000, TENSOR_CORES),
    "banded_4096": (1, 4096, 4096, 0, TENSOR_CORES),
}


@pytest.mark.parametrize("case", list(HYMBA_DENSE))
def test_dense_served_hymba(dev, case):
    """Kernel 5 at hymba's shapes, slots filled in order from position 0
    as its prefills fill them: an upload; the last 1024 queries of a
    6024-token prompt in an 8192-slot cache (the window masks keys below
    every query's position - 2047, and slots past the prompt are empty);
    the banded prefill of 2 windows (``kv_pos`` = the queries'
    positions).  Each with the window, held to the plain version."""
    b, sq, skv, q0, route = HYMBA_DENSE[case]
    g = torch.Generator(device=dev).manual_seed(34)
    n = q0 + sq
    kv_pos = torch.full((b, skv), INVALID_POS, dtype=torch.int32, device=dev)
    kv_pos[:, :n] = torch.arange(n, dtype=torch.int32, device=dev)
    q_pos = torch.arange(q0, n, dtype=torch.int32, device=dev).repeat(b, 1)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).bfloat16()

    _dense_check(randn(b, sq, 25, 64), randn(b, skv, 5, 64),
                 randn(b, skv, 5, 64), q_pos, kv_pos, 2048, route)


def test_dense_decode_hymba(dev):
    """Kernel 5's split keys at hymba's dense decode step: four slots of
    8192, an idle one (zeros), 40, 2100 and 6000 tokens; the window of
    2048 masks the keys below each newest query's position - 2047."""
    g = torch.Generator(device=dev).manual_seed(35)
    b, skv = 4, 8192
    kv_pos = torch.full((b, skv), INVALID_POS, dtype=torch.int32, device=dev)
    q_pos = torch.zeros((b, 1), dtype=torch.int32, device=dev)
    for i, n in enumerate([0, 40, 2100, 6000]):
        kv_pos[i, :n] = torch.arange(n, dtype=torch.int32, device=dev)
        q_pos[i] = max(n - 1, 0)
    q = torch.randn((b, 1, 25, 64), generator=g, device=dev).bfloat16()
    k = torch.randn((b, skv, 5, 64), generator=g, device=dev).bfloat16()
    v = torch.randn((b, skv, 5, 64), generator=g, device=dev).bfloat16()
    out = _dense_check(q, k, v, q_pos, kv_pos, 2048, SPLIT_KEYS)
    assert torch.all(out[0] == 0)


def test_dense_wrapper_rejects_what_the_kernel_does_not_take(dev):
    q, k, v, q_pos, kv_pos = _dense_inputs(dev, torch.float32, 8, 8, seed=6)
    with pytest.raises(ValueError):
        selective_attention(q.half(), k, v, q_pos, kv_pos)          # dtype
    with pytest.raises(ValueError):
        selective_attention(q, k, v, q_pos, kv_pos.long())          # index
    with pytest.raises(ValueError):
        selective_attention(q, k.transpose(1, 2), v, q_pos, kv_pos)  # layout
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    for args in ((_misaligned(qb), kb, vb), (qb, _misaligned(kb), vb),
                 (qb, kb, _misaligned(vb))):
        with pytest.raises(ValueError, match="aligned"):
            selective_attention(*args, q_pos, kv_pos)


def _ssd_inputs(dev, b, nc, h, q, hd, ds, seed, dt_hi=0.2):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    return (torch.randn((b, nc, h, q, hd), generator=g, device=dev),
            torch.randn((b, nc, q, ds), generator=g, device=dev),
            torch.randn((b, nc, q, ds), generator=g, device=dev),
            -(0.01 + 0.39 * rand(b, nc, h, q)),
            0.01 + (dt_hi - 0.01) * rand(b, nc, h, q))


def _ssd_check(args, route, views=None):
    """One launch of ``route`` on ``views`` (default ``args``): through the
    wrapper where the route is its choice for the shape, else launched by
    name; held per element to the plain version on ``args``."""
    ins = views or args
    kern = KERNELS["ssd_chunk"]
    before = kern.launches
    before_route = kern.route_launches.get(route, 0)
    if ssd_ops.ssd_route(ins[0].shape[3], ins[0].shape[4],
                         ins[1].shape[3]) == route:
        out = ssd_chunk(*ins)
    else:
        out = ssd_ops.launch_route(route, *ins)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    assert kern.route_launches.get(route, 0) == before_route + 1
    for o, r in zip(out, ssd_chunk_ref(*args)):
        assert bool(torch.isfinite(o).all())
        res = compare(o, r, limit=ssd_limit)
        assert res["worst"] <= 1.0, res


SSD_SHAPES = [(1, 2, 2, 8, 16, 8), (2, 3, 4, 16, 32, 16),
              (1, 4, 3, 32, 64, 128), (2, 2, 5, 64, 64, 16),
              (1, 21, 24, 64, 64, 128), (1, 6, 24, 64, 64, 128),
              (1, 3, 2, 128, 64, 128)]
SSD_ROUTES = (ssd_ops.TENSOR_CORES, ssd_ops.CUDA_CORES)
# every shape on the CUDA cores, and on the tensor cores where they take it
SSD_CASES = [(route, shape) for shape in SSD_SHAPES for route in SSD_ROUTES
             if route == ssd_ops.CUDA_CORES
             or ssd_ops.ssd_route(*shape[3:]) == route]


@pytest.mark.parametrize("route,shape", SSD_CASES,
                         ids=[f"{r}-{s}" for r, s in SSD_CASES])
def test_ssd_chunk_kernel(dev, route, shape):
    _ssd_check(_ssd_inputs(dev, *shape, seed=7), route)


def test_ssd_chunk_kernel_heads_not_divisible_by_group(dev):
    """(1, 40, 7): the planner groups the 7 heads of a chunk in threes on an
    H100 (120 blocks), so the last block of each chunk holds one head."""
    b, nc, h = 1, 40, 7
    g = ssd_ops.plan_head_groups(
        b, nc, h, torch.cuda.get_device_properties(dev).multi_processor_count)
    assert h % g != 0
    _ssd_check(_ssd_inputs(dev, b, nc, h, 64, 64, 128, seed=12),
               ssd_ops.TENSOR_CORES)


@pytest.mark.parametrize("route", SSD_ROUTES)
def test_ssd_chunk_kernel_pad_rows_and_large_dt(dev, route):
    x, bm, cm, la, dt = _ssd_inputs(dev, 1, 3, 4, 64, 64, 128, seed=8)
    la[:, -1, :, 29:] = 0.0                 # the last chunk's pad steps
    dt[:, -1, :, 29:] = 0.0
    _ssd_check((x, bm, cm, la, dt), route)
    # masked exponents overflow here (exp(60 * 63)); only a select keeps
    # them out of the sums
    _ssd_check((x, bm, cm, torch.full_like(la, -60.0),
                torch.full_like(dt, 4.0)), route)


@pytest.mark.parametrize("route,ds", [(ssd_ops.TENSOR_CORES, 128),
                                      (ssd_ops.CUDA_CORES, 32)])
def test_ssd_chunk_kernel_reads_the_model_layout(dev, route, ds):
    """x (B, NC, Q, H, hd), la/dt (B, NC, Q, H) and bm/cm cut from one
    (B, T, 2 ds) projection, passed as views, as ``ssd_chunked`` does."""
    b, nc, h, q, hd = 2, 3, 4, 64, 64
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn((b, nc, q, h, hd), generator=g, device=dev)
    bc = torch.randn((b, nc * q, 2 * ds), generator=g, device=dev)
    la = -0.3 * torch.rand((b, nc, q, h), generator=g, device=dev)
    dt = 0.2 * torch.rand((b, nc, q, h), generator=g, device=dev)
    bm, cm = (t.reshape(b, nc, q, ds) for t in bc.chunk(2, dim=-1))
    views = (x.permute(0, 1, 3, 2, 4), bm, cm, la.permute(0, 1, 3, 2),
             dt.permute(0, 1, 3, 2))
    assert not views[0].is_contiguous() and not bm.is_contiguous()
    assert ssd_ops.ssd_route(q, hd, ds) == route
    _ssd_check(tuple(t.contiguous() for t in views), route, views=views)


@pytest.mark.parametrize("nc", [9, 21, 95])
def test_ssd_chunk_hymba(dev, nc):
    """Kernel 6 at hymba's SSD heads (25 heads of 64, state 16, chunks of
    64) on the CUDA-core route, its route for ds 16, through the model's
    layout (bm/cm cut from one (B, T, 32) projection: 64-byte rows): an
    upload (9 chunks), a dialogue (21) and the ~6,000-token request
    (95)."""
    b, h, q, hd, ds = 1, 25, 64, 64, 16
    assert ssd_ops.ssd_route(q, hd, ds) == ssd_ops.CUDA_CORES
    g = torch.Generator(device=dev).manual_seed(14)
    x = torch.randn((b, nc, q, h, hd), generator=g, device=dev)
    bc = torch.randn((b, nc * q, 2 * ds), generator=g, device=dev)
    la = -0.3 * torch.rand((b, nc, q, h), generator=g, device=dev)
    dt = 0.2 * torch.rand((b, nc, q, h), generator=g, device=dev)
    bm, cm = (t.reshape(b, nc, q, ds) for t in bc.chunk(2, dim=-1))
    views = (x.permute(0, 1, 3, 2, 4), bm, cm, la.permute(0, 1, 3, 2),
             dt.permute(0, 1, 3, 2))
    _ssd_check(tuple(t.contiguous() for t in views), ssd_ops.CUDA_CORES,
               views=views)


def test_ssd_wrapper_rejects_what_the_kernel_does_not_take(dev):
    x, bm, cm, la, dt = _ssd_inputs(dev, 1, 2, 2, 16, 32, 16, seed=10)
    with pytest.raises(ValueError):
        ssd_chunk(x.double(), bm, cm, la, dt)                     # dtype
    with pytest.raises(ValueError):
        ssd_chunk(x, bm.transpose(2, 3), cm, la, dt)              # layout
    big = _ssd_inputs(dev, 1, 1, 1, 256, 32, 16, seed=11)
    with pytest.raises(ValueError, match="chunk length"):
        ssd_chunk(*big)                                           # Q > 128
    # the tensor cores copy 16-byte vectors: a row 4 bytes off raises
    x, bm, cm, la, dt = _ssd_inputs(dev, 1, 2, 2, 64, 64, 128, seed=13)
    xm = torch.randn((1, 2, 2, 64, 65), device=dev)[..., 1:]
    with pytest.raises(ValueError, match="aligned"):
        ssd_chunk(xm, bm, cm, la, dt)


# -- the spool-to-pool int8 link (plain PyTorch, no kernel of its own) -------

@pytest.mark.parametrize("block_tokens", [None, 16])
def test_link_write_q8_matches_cpu(dev, block_tokens):
    """``PagedKVPool.link_write_q8`` on the card against the same call on
    the CPU: two int8 segments (whole-sequence or 16-token block scales)
    relinked onto a pool whose pages already hold int8 rows and scales, with
    the scratch page absorbing the pad rows.  V is bit-identical (dequantize,
    amax, divide and round are exact); K goes through the RoPE rotation,
    whose cos/sin may differ by an ulp between the devices, so K's scales
    are held to 1e-6 relative and its bytes to one quantization step."""
    cfg = PagedConfig(num_pages=24, page_size=PS, num_layers=2,
                      num_kv_heads=4, head_dim=DH, dtype="int8")
    g = torch.Generator().manual_seed(21)
    seg_len, n_pad = (120, 77), 59                  # 197 placed + 59 = 256
    segs = [[quantize_kv(torch.randn((2, n, 4, DH), generator=g) * 3,
                         block_tokens) for _ in "kv"] for n in seg_len]
    q_k = torch.cat([k.q for k, _ in segs]
                    + [torch.zeros((2, n_pad, 4, DH), dtype=torch.int8)], 1)
    q_v = torch.cat([v.q for _, v in segs]
                    + [torch.zeros((2, n_pad, 4, DH), dtype=torch.int8)], 1)
    s_k = torch.cat([k.scale for k, _ in segs], 1)
    s_v = torch.cat([v.scale for _, v in segs], 1)
    rows, base = [], 0
    for (k, _), n in zip(segs, seg_len):
        rows.append(base + scale_row_ids(n, k))
        base += k.scale.shape[1]
    seg_ids = torch.as_tensor(np.concatenate(rows + [np.zeros(n_pad,
                                                               np.int32)]))
    slots = np.concatenate([np.arange(5, 125), np.arange(140, 217)])
    pages = np.concatenate([1 + slots // PS, np.zeros(n_pad, np.int64)])
    offs = np.concatenate([slots % PS, np.zeros(n_pad, np.int64)])
    delta = np.concatenate([np.full(120, 5), np.full(77, 140),
                            np.zeros(n_pad)]).astype(np.int32)
    pools = {}
    for where in ("cpu", dev):
        pool = PagedKVPool(cfg, device=where)
        gp = torch.Generator().manual_seed(22)      # same resident rows
        for buf in (pool.k, pool.v):
            buf.copy_(torch.randint(-127, 128, buf.shape, generator=gp,
                                    dtype=torch.int8))
        for sc in (pool.k_scale, pool.v_scale):
            sc.copy_(torch.rand(sc.shape, generator=gp) * 0.05)
        to = {"device": pool.device}
        pool.link_write_q8(
            torch.as_tensor(pages, **to), torch.as_tensor(offs, **to),
            q_k.to(**to), s_k.to(**to), q_v.to(**to), s_v.to(**to),
            seg_ids.to(**to), torch.as_tensor(delta, **to), theta=10000.0,
            relink=True)
        pools[str(where)] = pool
    cpu, card = pools["cpu"], pools[str(dev)]
    assert torch.equal(card.v.cpu(), cpu.v)
    assert torch.equal(card.v_scale.cpu(), cpu.v_scale)
    torch.testing.assert_close(card.k_scale.cpu(), cpu.k_scale, rtol=1e-6,
                               atol=0)
    assert int((card.k.cpu().int() - cpu.k.int()).abs().max()) <= 1
    with pytest.raises(ValueError, match="int8 pool"):
        PagedKVPool(dataclasses.replace(cfg, dtype="bfloat16"),
                    device=dev).link_write_q8(
            torch.as_tensor(pages, device=dev), None, None, None, None,
            None, None, None, theta=1.0, relink=False)


def _lse_check(q, k, v, q_pos, kv_pos, window, route):
    """``return_lse=True`` on ``route``: one launch counted there, the
    output and each row's log-sum-exp per element against the plain
    version's pair (the log-sum-exp at the fp32 limit, exact ``-inf`` on a
    row with no kept key)."""
    kern = KERNELS["sel_attn"]
    before = kern.route_launches.get(route, 0)
    out, lse = selective_attention(q, k, v, q_pos, kv_pos, window=window,
                                   return_lse=True)
    torch.cuda.synchronize()
    assert kern.route_launches.get(route, 0) == before + 1
    ref, ref_lse = selective_attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), q_pos,
        kv_pos, window=window, return_lse=True)
    res = compare(out, ref.transpose(1, 2), v_absmax(v))
    assert res["worst"] <= 1.0, res
    ref_lse = ref_lse.transpose(1, 2)
    assert lse.shape == ref_lse.shape and lse.dtype == torch.float32
    empty = torch.isinf(ref_lse)
    assert torch.equal(torch.isinf(lse), empty)
    assert torch.all(lse[empty] < 0)
    err = (lse - ref_lse)[~empty].abs()
    assert float(err.max()) <= 1e-4 * (1 + float(ref_lse[~empty].abs().max()))


@pytest.mark.parametrize("dh,hq,hkv,skv", [(128, 16, 16, 4096),
                                           (64, 10, 2, 1000),
                                           (128, 32, 8, 257)],
                         ids=["llava-rank-slice", "gqa5", "gqa4"])
@DENSE_WINDOWS
def test_dense_lse_split_route(dev, dh, hq, hkv, skv, window):
    """The long decode's rank slice (one query, 16 heads on 16 kv heads,
    4,096 keys) and GQA shapes: the split-key route's log-sum-exp."""
    q, k, v, q_pos, kv_pos = _dense_case(dev, 2, 1, skv, hq, hkv, dh,
                                         seed=23)
    _lse_check(q, k, v, q_pos, kv_pos, window, SPLIT_KEYS)


@WINDOWS
def test_dense_lse_cuda_core_route(dev, window):
    q, k, v, q_pos, kv_pos = _dense_inputs(dev, torch.float32, 32, 8,
                                           seed=24)
    _lse_check(q, k, v, q_pos, kv_pos, window, CUDA_CORES)


def test_dense_lse_raises_on_the_tensor_core_route(dev):
    q, k, v, q_pos, kv_pos = _dense_case(dev, 1, 65, 129, 8, 8, 128, seed=25)
    with pytest.raises(ValueError, match="log-sum-exp"):
        selective_attention(q, k, v, q_pos, kv_pos, return_lse=True)
