"""The port's plain versions of the four paged attention kernels against the
JAX package's Pallas kernels (interpret mode) and its ``ref.py`` oracles.

Kernels 1-2 (selective prefill, 16-bit and int8 pool) and 3-4 (decode,
16-bit and int8 pool), over MHA and GQA (group 4), window 0 and 8, a page
table padded with a scratch page, a ragged number of queries, and one row
with ``lengths == 0``.  Such a decode row is compared only with the JAX
``ref.py``: the Pallas kernel (like the port's CUDA kernel) returns zeros
there, the oracles return the uniform mean of the gathered values.
Tolerance: atol 2e-5, rtol 1e-5 (fp32 sums in another order).
"""
import numpy as np
import pytest
import torch

from repro.kernels.paged_attn.ops import paged_attention as jax_paged
from repro.kernels.selective_attn.ops import (
    selective_attention_paged as jax_selective,
)
from repro_torch.kernels import KERNELS
from repro_torch.kernels.paged_attn.ops import paged_attention
from repro_torch.kernels.selective_attn.ops import selective_attention_paged

TOL = dict(atol=2e-5, rtol=1e-5)
PS, P, MP, DH = 8, 12, 5, 16
SCRATCH = 0
LENGTHS = [0, 19, 37]          # one idle row, a partial page, a full table


def _inputs(hq, hkv, pool, seed):
    rng = np.random.default_rng(seed)
    b = len(LENGTHS)
    if pool == "int8":
        kp = rng.integers(-127, 128, (P, PS, hkv, DH)).astype(np.int8)
        vp = rng.integers(-127, 128, (P, PS, hkv, DH)).astype(np.int8)
        ks = rng.uniform(0.002, 0.02, (P, hkv)).astype(np.float32)
        vs = rng.uniform(0.002, 0.02, (P, hkv)).astype(np.float32)
    else:
        kp = rng.standard_normal((P, PS, hkv, DH)).astype(np.float32)
        vp = rng.standard_normal((P, PS, hkv, DH)).astype(np.float32)
        ks = vs = None
    # distinct real pages per row, scratch-padded past the row's length
    perm = rng.permutation(np.arange(1, P))
    pt = np.full((b, MP), SCRATCH, np.int32)
    used = 0
    for i, n in enumerate(LENGTHS):
        npg = -(-n // PS)
        pt[i, :npg] = perm[used:used + npg]
        used += npg
    return kp, vp, ks, vs, pt, np.asarray(LENGTHS, np.int32), rng


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _scales(ks, vs):
    return {} if ks is None else {"k_scale": ks, "v_scale": vs}


CASES = pytest.mark.parametrize("pool", ["fp32", "int8"])
HEADS = pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)], ids=["mha", "gqa4"])
WINDOWS = pytest.mark.parametrize("window", [0, 8])


@CASES
@HEADS
@WINDOWS
def test_paged_decode_plain_matches_pallas(hq, hkv, window, pool):
    kp, vp, ks, vs, pt, lengths, rng = _inputs(hq, hkv, pool, seed=1)
    q = rng.standard_normal((len(LENGTHS), hq, DH)).astype(np.float32)
    pallas = np.asarray(jax_paged(q, kp, vp, pt, lengths, window=window,
                                  interpret=True, **_scales(ks, vs)))
    oracle = np.asarray(jax_paged(q, kp, vp, pt, lengths, window=window,
                                  use_ref=True, **_scales(ks, vs)))
    tks, tvs = _t(ks), _t(vs)
    out = paged_attention(_t(q), _t(kp), _t(vp), _t(pt), _t(lengths),
                          k_scale=tks, v_scale=tvs, window=window).numpy()
    live = lengths > 0
    np.testing.assert_allclose(out[live], pallas[live], **TOL)
    np.testing.assert_allclose(out, oracle, **TOL)
    assert not live.all()


@CASES
@HEADS
@WINDOWS
def test_selective_prefill_plain_matches_pallas(hq, hkv, window, pool):
    kp, vp, ks, vs, pt, lengths, rng = _inputs(hq, hkv, pool, seed=2)
    sq = 11                       # ragged: not a multiple of block_q
    q = rng.standard_normal((len(LENGTHS), sq, hq, DH)).astype(np.float32)
    q_pos = np.stack([np.sort(rng.choice(max(n, sq), sq, replace=False))
                      for n in LENGTHS]).astype(np.int32)
    args = (q, kp, vp, pt, q_pos, lengths)
    pallas = np.asarray(jax_selective(*args, window=window, block_q=8,
                                      interpret=True, **_scales(ks, vs)))
    oracle = np.asarray(jax_selective(*args, window=window, use_ref=True,
                                      **_scales(ks, vs)))
    out = selective_attention_paged(
        *map(_t, args), k_scale=_t(ks), v_scale=_t(vs),
        window=window).numpy()
    np.testing.assert_allclose(out, pallas, **TOL)
    np.testing.assert_allclose(out, oracle, **TOL)
    assert np.all(out[0] == 0)        # no valid key: zeros, like Pallas


def test_cpu_dispatch_launches_no_kernel():
    kp, vp, ks, vs, pt, lengths, rng = _inputs(4, 4, "int8", seed=3)
    before = {k: v.launches for k, v in KERNELS.items()}
    q = _t(rng.standard_normal((len(LENGTHS), 4, DH)).astype(np.float32))
    paged_attention(q, _t(kp), _t(vp), _t(pt), _t(lengths),
                    k_scale=_t(ks), v_scale=_t(vs))
    assert {k: v.launches for k, v in KERNELS.items()} == before
