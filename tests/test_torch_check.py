"""The bf16 tolerance that holds the CUDA kernels to their plain versions
(``repro_torch.kernels.check``), exercised on the CPU at the decode shape
of the main path: four sequences of 1.3k-1.9k keys, N(0,1) K/V as the
seeded model gives at layer 0, bf16 q, bf16 or int8 pool.

A stand-in for a correct kernel (the plain version with the full pages of
each row visited in reverse order: the same keys, summed in another order)
must pass.  Stand-ins for a kernel that drops the newest key, the ragged
last page or a few pages' K scales must fail it.

The same for the dense selective attention at the dense decode step's
shape: four slots of a 2048-slot cache holding 1.3k-1.9k tokens at
permuted slots, the rest empty (``INVALID_POS``, with a previous tenant's
K/V left in them, as a dense cache keeps them).  A reordered sum passes; a
kernel that reads the empty slots as keys, or whose window edge is off by
one, fails.

Why the bf16 paged prefill kernel splits P in two for its tensor-core
P.V: at the main path's shape (224 sorted queries among 1312 keys, Dh 128,
bf16 and int8 pools) P rounded once to bf16 breaks the limit ~20-26x, P
split into hi = bf16(p) and lo = bf16(p - hi) stays within it (0.96).  The
dense tensor-core route needs the split as much: the same 224 queries
against 1312 tokens at permuted slots of a 2048-slot dense cache.

Why the split-key decode kernel merges its partials as it does: at the
same decode shape, partials per 256-key split in fp32 merged with the
``exp(m_s - m_max)`` rescale and rounded once pass the limit; a merge that
skips the rescale fails it; with the finite ``NEG_INF`` an idle row (every
split empty) merges to exact zeros, while a true ``-inf`` gives NaN there.
The same holds for the dense decode route, whose splits are 256-slot
chunks of a dense cache with positions in any order
(``selective_attn.ops.plan_dense_splits``).

The SSD chunk limit (``1e-4 + 1e-4 * |ref|``) at mamba2's chunk shape: a
float64 evaluation of the same sums passes at 0.03 of the limit; a kernel
that drops the diagonal or key 0, decays one step short or leaves the last
step out of the chunk state fails by more than 1000x.  Why its tensor-core
route runs three TF32 products per fp32 product: TF32 rounding emulated on
the CPU, one product misses the limit ~45x, three stay at ~0.04 of it.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.check import compare, v_absmax
from repro_torch.kernels.paged_attn.ref import paged_attention_ref
from repro_torch.kernels.selective_attn.ref import (
    INVALID_POS,
    selective_attention_ref,
)

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


SKV, DENSE_HQ, WINDOW = 2048, 8, 1024


def _dense_decode_inputs():
    g = torch.Generator().manual_seed(1)
    b = len(LENGTHS)
    k = torch.randn((b, HKV, SKV, DH), generator=g).to(torch.bfloat16)
    v = torch.randn((b, HKV, SKV, DH), generator=g).to(torch.bfloat16)
    kv_pos = torch.full((b, SKV), INVALID_POS, dtype=torch.int32)
    for i, n in enumerate(LENGTHS):
        slots = torch.randperm(SKV, generator=g)[:n]
        kv_pos[i, slots] = torch.arange(n, dtype=torch.int32)
    # the query is the newest token, at position n - 1
    q_pos = torch.tensor(LENGTHS, dtype=torch.int32)[:, None] - 1
    q = torch.randn((b, DENSE_HQ, 1, DH), generator=g).to(torch.bfloat16)
    return q, k, v, q_pos, kv_pos


def _dense_stand_in(mutation, q, k, v, q_pos, kv_pos, window):
    """What a dense kernel with the given fault would return."""
    if mutation == "reordered":              # correct: another slot order
        perm = torch.randperm(SKV, generator=torch.Generator().manual_seed(2))
        k, v, kv_pos = k[:, :, perm], v[:, :, perm], kv_pos[:, perm]
    elif mutation == "empty_slots":          # INVALID_POS not masked: an
        slot = torch.arange(SKV, dtype=torch.int32)   # empty slot read as
        kv_pos = torch.where(kv_pos == INVALID_POS,   # the key at its index
                             slot[None], kv_pos)
    elif mutation == "window_edge":          # kv_pos >= q_pos - window
        window += 1
    return selective_attention_ref(q, k, v, q_pos, kv_pos, window=window)


@pytest.mark.parametrize("mutation,window", [
    ("reordered", 0), ("reordered", WINDOW), ("empty_slots", 0),
    ("window_edge", WINDOW)])
def test_bf16_limit_catches_dense_kernel_faults(mutation, window):
    q, k, v, q_pos, kv_pos = _dense_decode_inputs()
    ref = selective_attention_ref(q, k, v, q_pos, kv_pos, window=window)
    out = _dense_stand_in(mutation, q, k, v, q_pos, kv_pos, window)
    assert out.dtype == torch.bfloat16
    res = compare(out, ref, v_absmax(v))
    assert math.isfinite(res["worst"])
    if mutation == "reordered":
        assert res["worst"] <= 1.0, res
    else:
        assert res["worst"] > 1.0, res


def _ssd_f64(x, bm, cm, la, dt, fault=None):
    """The SSD chunk step in float64 (another rounding of the same sums),
    or with one fault a kernel could have."""
    x, bm, cm, la, dt = (t.double() for t in (x, bm, cm, la, dt))
    q = x.shape[-2]
    cum = torch.cumsum(la, dim=-1)
    if fault == "exclusive_cumsum":             # decays one step short
        cum = cum - la
    keep = torch.ones((q, q), dtype=torch.bool).tril(
        -1 if fault == "no_diagonal" else 0)
    if fault == "dropped_key":                  # key 0 never seen
        keep[:, 0] = False
    cb = torch.einsum("bnqs,bnks->bnqk", cm, bm)
    diff = torch.where(keep, cum[..., :, None] - cum[..., None, :], 0.0)
    scores = torch.where(keep, cb[:, :, None] * torch.exp(diff)
                         * dt[..., None, :], 0.0)
    y = torch.einsum("bnhqk,bnhkd->bnhqd", scores, x)
    total = cum[..., -1]
    wgt = torch.exp(total[..., None] - cum) * dt
    if fault == "state_drops_last_step":
        wgt[..., -1] = 0.0
    s = torch.einsum("bnqs,bnhq,bnhqd->bnhsd", bm, wgt, x)
    return y.float(), s.float(), torch.exp(total).float()


@pytest.mark.parametrize("fault", [None, "no_diagonal", "dropped_key",
                                   "exclusive_cumsum",
                                   "state_drops_last_step"])
def test_ssd_limit_separates_faults_from_rounding(fault):
    """At mamba2's chunk shape (Q 64, hd 64, ds 128) and the JAX package's
    test distributions, a float64 evaluation of the same sums passes the
    SSD limit; each fault fails it on some output by a wide margin."""
    args = _ssd_limit_inputs()
    worst = _ssd_worst(_ssd_f64(*args, fault), args)
    if fault is None:
        assert worst <= 0.5
    else:
        assert worst > 100.0


def _ssd_limit_inputs():
    """mamba2's chunk shape (Q 64, hd 64, ds 128), four chunks of four
    heads, the JAX package's test distributions."""
    g = torch.Generator().manual_seed(3)
    b, nc, h, q, hd, ds = 1, 4, 4, 64, 64, 128
    return (torch.randn((b, nc, h, q, hd), generator=g),
            torch.randn((b, nc, q, ds), generator=g),
            torch.randn((b, nc, q, ds), generator=g),
            -(0.01 + 0.39 * torch.rand((b, nc, h, q), generator=g)),
            0.01 + 0.19 * torch.rand((b, nc, h, q), generator=g))


def _ssd_worst(outs, args):
    """The largest err/limit of ``outs`` against the plain version."""
    from repro_torch.kernels.check import ssd_limit
    from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref

    return max(compare(o, r, limit=ssd_limit)["worst"]
               for o, r in zip(outs, ssd_chunk_ref(*args)))


# The tensor-core route of the SSD chunk kernel runs its three products on
# TF32 operands (10 mantissa bits).  Emulated here on the int32 view
# (cvt.rna: round to nearest, ties away from zero): one TF32 product per
# fp32 product misses the SSD limit many times over; three (hi.hi + hi.lo
# + lo.hi with hi = tf32(a), lo = tf32(a - hi), the small terms summed
# apart and added last) stay far inside it.  It guards the kernel's three
# passes, and the limit against being loosened to fit one.
def _tf32(t):
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_matmul(a, b, passes):
    """a @ b with each operand rounded to TF32 (one pass) or split in two
    TF32 halves (three passes); products exact, sums in fp32."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    big = a_hi @ b_hi
    if passes == 1:
        return big
    small = a_hi @ _tf32(b - b_hi) + _tf32(a - a_hi) @ b_hi
    return big + small


def _ssd_tf32(x, bm, cm, la, dt, passes):
    """The SSD chunk step as the tensor-core route computes it: C.B^T, then
    S = C.B^T exp(cum_q - cum_k) dt_k (k > q selected away) and the weights
    B w in fp32, each product on TF32 operands."""
    q = x.shape[-2]
    cum = torch.cumsum(la, dim=-1)
    keep = torch.ones((q, q), dtype=torch.bool).tril()
    cb = _tf32_matmul(cm, bm.transpose(-1, -2), passes)      # (B,NC,Q,Q)
    diff = torch.where(keep, cum[..., :, None] - cum[..., None, :], 0.0)
    scores = torch.where(keep, cb[:, :, None] * torch.exp(diff)
                         * dt[..., None, :], 0.0)
    y = _tf32_matmul(scores, x, passes)
    total = cum[..., -1]
    wgt = torch.exp(total[..., None] - cum) * dt              # (B,NC,H,Q)
    bw = (bm[:, :, None] * wgt[..., None]).transpose(-1, -2)  # (B,NC,H,ds,Q)
    s = _tf32_matmul(bw, x, passes)
    return y, s, torch.exp(total)


@pytest.mark.parametrize("passes", [1, 3], ids=["one_pass", "three_pass"])
def test_ssd_limit_needs_three_tf32_products(passes):
    args = _ssd_limit_inputs()
    worst = _ssd_worst(_ssd_tf32(*args, passes), args)
    if passes == 1:
        assert worst > 4.0, worst
    else:
        assert worst <= 0.5, worst


# The bf16 paged prefill kernel's P.V on the tensor cores takes P in 16
# bits.  At the main path's shape (224 selected queries, sorted, among 1312
# cached keys; Dh 128), rounding P once to bf16 breaks the limit many times
# over; splitting it into hi = bf16(p) and lo = bf16(p - hi), both
# multiplied by the same bf16 V, keeps within it.  This is why the kernel
# runs two products, and it guards the limit against being loosened to fit
# a cheaper kernel.
SEL_LEN, SEL_N, SEL_H = 1312, 224, 4


def _selective_inputs(pool):
    rng = np.random.default_rng(7)
    npg = -(-SEL_LEN // PS)
    p = npg + 1                               # page 0 is the scratch page

    def bf16(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(torch.bfloat16)

    q = bf16(1, SEL_H, SEL_N, DH)
    k, v = bf16(p, PS, SEL_H, DH), bf16(p, PS, SEL_H, DH)
    ks = vs = None
    if pool == "int8":
        ks = k.float().abs().amax(dim=(1, 3)) / 127
        vs = v.float().abs().amax(dim=(1, 3)) / 127
        k = torch.round(k.float() / ks[:, None, :, None]).to(torch.int8)
        v = torch.round(v.float() / vs[:, None, :, None]).to(torch.int8)
    pt = torch.from_numpy(rng.permutation(npg).astype(np.int32) + 1)[None]
    q_pos = torch.from_numpy(np.sort(rng.choice(
        SEL_LEN, SEL_N, replace=False)).astype(np.int32))[None]
    lens = torch.tensor([SEL_LEN], dtype=torch.int32)
    return q, k, v, ks, vs, pt, q_pos, lens


def _dense_selective_inputs():
    """The same 224 sorted queries against 1312 tokens, held at permuted
    slots of a 2048-slot dense cache (the rest empty), bf16."""
    rng = np.random.default_rng(8)

    def bf16(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(torch.bfloat16)

    q = bf16(1, SEL_H, SEL_N, DH)
    k, v = bf16(1, SEL_H, SKV, DH), bf16(1, SEL_H, SKV, DH)
    kv_pos = np.full((1, SKV), INVALID_POS, np.int32)
    kv_pos[0, rng.permutation(SKV)[:SEL_LEN]] = np.arange(SEL_LEN)
    q_pos = np.sort(rng.choice(SEL_LEN, SEL_N, replace=False))[None]
    return (q, k, v, torch.from_numpy(q_pos.astype(np.int32)),
            torch.from_numpy(kv_pos))


def _pv_in_16_bits(split, q, k, v, ks, vs, pt, q_pos, lens):
    """The paged prefill with fp32 logits and softmax, and P.V fed bf16 P
    (once, or split into two bf16 halves) against bf16 V, summed in fp32,
    divided by the fp32 normaliser and rounded once."""
    b, hq, sq, dh = q.shape
    n = pt.shape[1] * PS
    kg = k[pt.long()].reshape(b, n, -1, dh).float().transpose(1, 2)
    vg = v[pt.long()].reshape(b, n, -1, dh).float().transpose(1, 2)
    idx = torch.arange(n)
    keep = (idx < lens[:, None, None, None]) & (idx <= q_pos[:, None, :, None])
    k_mul = v_mul = None
    if ks is not None:
        k_mul = torch.repeat_interleave(
            ks[pt.long()], PS, dim=1).transpose(1, 2)[:, :, None, :]
        v_mul = torch.repeat_interleave(
            vs[pt.long()], PS, dim=1).transpose(1, 2)[:, :, None, :]
    return _p_split_pv(split, q, kg, vg, keep, k_mul, v_mul)


def _dense_pv_in_16_bits(split, q, k, v, q_pos, kv_pos):
    """The same for the dense tensor-core route: keys kept by their own
    kv_pos."""
    kp = kv_pos.long()[:, None, None, :]
    keep = (kp != INVALID_POS) & (kp <= q_pos.long()[:, None, :, None])
    return _p_split_pv(split, q, k.float(), v.float(), keep)


def _p_split_pv(split, q, kg, vg, keep, k_mul=None, v_mul=None):
    """fp32 logits (times ``k_mul``, the K scales) and softmax over the kept
    keys; P (times ``v_mul``, the V scales, which join P and not the
    normaliser) fed to P.V as bf16, once or split in two, against bf16 V."""
    dh = q.shape[-1]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kg) / math.sqrt(dh)
    if k_mul is not None:
        logits = logits * k_mul
    logits = torch.where(keep, logits, -1e30)
    p = torch.where(keep, torch.exp(logits - logits.amax(-1, keepdim=True)),
                    0.0)
    l_sum = p.sum(-1, keepdim=True)
    if v_mul is not None:
        p = p * v_mul
    hi = p.to(torch.bfloat16).float()
    out = torch.einsum("bhqk,bhkd->bhqd", hi, vg)
    if split:
        lo = (p - hi).to(torch.bfloat16).float()
        out = out + torch.einsum("bhqk,bhkd->bhqd", lo, vg)
    return (out / l_sum).to(torch.bfloat16)


@pytest.mark.parametrize("pool", ["bf16", "int8", "dense"])
@pytest.mark.parametrize("split", [False, True], ids=["p_once", "p_split"])
def test_bf16_limit_needs_p_split_in_two(pool, split):
    from repro_torch.kernels.selective_attn.ref import (
        selective_attention_paged_ref,
    )

    if pool == "dense":
        q, k, v, q_pos, kv_pos = _dense_selective_inputs()
        ref = selective_attention_ref(q, k, v, q_pos, kv_pos)
        out = _dense_pv_in_16_bits(split, q, k, v, q_pos, kv_pos)
        vs = None
    else:
        args = _selective_inputs(pool)
        q, k, v, ks, vs, pt, q_pos, lens = args
        ref = selective_attention_paged_ref(q, k, v, pt, q_pos, lens, ks, vs)
        out = _pv_in_16_bits(split, *args)
    res = compare(out, ref, v_absmax(v, vs))
    if split:
        assert res["worst"] <= 1.0, res
    else:
        assert res["worst"] > 4.0, res


# The split-key decode kernel (csrc/paged_attn.cu) in fp32 on the CPU: one
# partial (m, l, acc) per (row, query head, split of 256 keys counted from
# the row's first valid key), empty splits carrying (neg_inf, 0, 0), merged
# by the rescale exp(m_s - m_max), divided by the merged l (zeros where it
# is 0) and rounded once to q's dtype.
def _split_decode(q, k, v, ks, vs, pt, lens, window=0, neg_inf=-1e30,
                  rescale=True):
    from repro_torch.kernels.paged_attn.ops import plan_splits

    b, hq, dh = q.shape
    _, ps, hkv, _ = k.shape
    plan = plan_splits(b, hq, dh, pt.shape[1], ps, window)
    out = torch.zeros((b, hq, dh))
    for i in range(b):
        qi = q[i].float().reshape(hkv, hq // hkv, dh)
        m, l, acc = [], [], []
        for s in range(plan.n_splits):
            keys = torch.tensor(plan.split_keys(int(lens[i]), s),
                                dtype=torch.long)
            if len(keys) == 0:
                m.append(torch.full((hq,), neg_inf))
                l.append(torch.zeros(hq))
                acc.append(torch.zeros((hq, dh)))
                continue
            page = pt[i, keys // ps].long()
            kk = k[page, keys % ps].float()               # (n, Hkv, Dh)
            vv = v[page, keys % ps].float()
            x = torch.einsum("hgd,nhd->hgn", qi, kk) / math.sqrt(dh)
            if ks is not None:
                x = x * ks[page].T[:, None, :]
            ms = x.amax(-1)
            p = torch.exp(x - ms[..., None])
            l.append(p.sum(-1).reshape(hq))
            if vs is not None:                  # the V scale joins P, not l
                p = p * vs[page].T[:, None, :]
            acc.append(torch.einsum("hgn,nhd->hgd", p, vv).reshape(hq, dh))
            m.append(ms.reshape(hq))
        m, l, acc = torch.stack(m), torch.stack(l), torch.stack(acc)
        w = torch.exp(m - m.amax(0)) if rescale else torch.ones_like(m)
        lsum = (w * l).sum(0)
        o = (w[..., None] * acc).sum(0)
        out[i] = torch.where(lsum[:, None] == 0, 0.0, o / lsum[:, None])
    return out.to(q.dtype)


def _split_dense(q, k, v, q_pos, kv_pos, window=0, neg_inf=-1e30,
                 rescale=True):
    """The dense decode route (csrc/selective_attn.cu) in fp32 on the CPU:
    one partial per (row, chunk of 256 slots from slot 0) over the slots
    the row keeps by their kv_pos, (neg_inf, 0, 0) where it keeps none,
    merged as the paged decode merges.  q (B, Hq, Sq, Dh), k/v
    (B, Hkv, Skv, Dh)."""
    from repro_torch.kernels.selective_attn.ops import plan_dense_splits

    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    plan = plan_dense_splits(b, sq, hq, dh, skv)
    kk = k.float().repeat_interleave(hq // hkv, dim=1)
    vv = v.float().repeat_interleave(hq // hkv, dim=1)
    kp = kv_pos.long()[:, None, None, :]
    qp = q_pos.long()[:, None, :, None]
    keep = (kp != INVALID_POS) & (kp <= qp)
    if window > 0:
        keep &= kp > qp - window
    keep = keep.expand(b, hq, sq, skv)
    m, l, acc = [], [], []
    for s in range(plan.n_splits):
        slots = torch.tensor(plan.chunk_slots(s), dtype=torch.long)
        x = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                         kk[:, :, slots]) / math.sqrt(dh)
        kept = keep[..., slots]
        ms = torch.where(kept, x, -math.inf).amax(-1)
        any_kept = kept.any(-1)
        ms = torch.where(any_kept, ms, neg_inf)
        p = torch.where(kept, torch.exp(x - ms[..., None]), 0.0)
        m.append(ms)
        l.append(p.sum(-1))
        acc.append(torch.einsum("bhqk,bhkd->bhqd", p, vv[:, :, slots]))
    m, l, acc = torch.stack(m), torch.stack(l), torch.stack(acc)
    w = torch.exp(m - m.amax(0)) if rescale else torch.ones_like(m)
    lsum = (w * l).sum(0)
    o = (w[..., None] * acc).sum(0)
    out = torch.where(lsum[..., None] == 0, 0.0, o / lsum[..., None])
    return out.to(q.dtype)


@pytest.mark.parametrize("pool", ["bf16", "int8", "dense"])
@pytest.mark.parametrize("rescale", [True, False],
                         ids=["rescaled", "no_rescale"])
def test_split_key_merge_needs_the_rescale(pool, rescale):
    if pool == "dense":
        q, k, v, q_pos, kv_pos = _dense_decode_inputs()
        ref = selective_attention_ref(q, k, v, q_pos, kv_pos)
        out = _split_dense(q, k, v, q_pos, kv_pos, rescale=rescale)
        res = compare(out, ref, v_absmax(v))
        assert math.isfinite(res["worst"])
        assert (res["worst"] <= 1.0) == rescale, res
        return
    q, k, v, ks, vs, pt, lens = _decode_inputs(pool)
    ref = paged_attention_ref(q, k, v, pt, lens, ks, vs)
    out = _split_decode(q, k, v, ks, vs, pt, lens, rescale=rescale)
    res = compare(out, ref, v_absmax(v, vs))
    assert math.isfinite(res["worst"])
    if rescale:
        assert res["worst"] <= 1.0, res
    else:
        assert res["worst"] > 10.0, res


@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_split_key_empty_splits(pool):
    """An idle row (length 0: every split empty) merges to exact zeros with
    the finite NEG_INF and to NaN with a true -inf; a window of 600 that
    leaves a 300-key row's third split empty, and the longer rows' splits
    starting mid-page, still pass."""
    q, k, v, ks, vs, pt, lens = _decode_inputs(pool)
    lens = lens.clone()
    lens[0], lens[1] = 0, 300
    live = lens > 0
    for window in (0, 600):
        ref = paged_attention_ref(q, k, v, pt, lens, ks, vs, window=window)
        out = _split_decode(q, k, v, ks, vs, pt, lens, window=window)
        assert torch.all(out[0] == 0)
        res = compare(out, ref, v_absmax(v, vs), rows=live)
        assert res["worst"] <= 1.0, res
    out = _split_decode(q, k, v, ks, vs, pt, lens, neg_inf=-math.inf)
    assert torch.isnan(out[0].float()).all()
    assert not torch.isnan(out[live].float()).any()


def test_dense_split_empty_chunks():
    """The dense decode route's emulation: a sequence with no valid slot
    (every chunk empty) merges to exact zeros with the finite NEG_INF and
    to NaN with a true -inf; a 300-token sequence in slots 0-299 (six of
    eight chunks empty) and windows of 600 and 64 still pass against the
    plain version."""
    q, k, v, q_pos, kv_pos = _dense_decode_inputs()
    kv_pos = kv_pos.clone()
    kv_pos[0] = INVALID_POS
    kv_pos[1] = INVALID_POS
    kv_pos[1, :300] = torch.arange(300, dtype=torch.int32)
    q_pos = q_pos.clone()
    q_pos[1] = 299
    for window in (0, 600, 64):
        ref = selective_attention_ref(q, k, v, q_pos, kv_pos, window=window)
        out = _split_dense(q, k, v, q_pos, kv_pos, window=window)
        assert torch.all(out[0] == 0)
        res = compare(out, ref, v_absmax(v))
        assert res["worst"] <= 1.0, res
    out = _split_dense(q, k, v, q_pos, kv_pos, neg_inf=-math.inf)
    assert torch.isnan(out[0].float()).all()
    assert not torch.isnan(out[1:].float()).any()
