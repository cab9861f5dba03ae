"""The port's plain versions of the five attention kernels against the JAX
package's Pallas kernels (interpret mode) and its ``ref.py`` oracles.

Kernels 1-2 (selective prefill, 16-bit and int8 pool) and 3-4 (decode,
16-bit and int8 pool), over MHA and GQA (group 4), window 0 and 8, a page
table padded with a scratch page, a ragged number of queries, and one row
with ``lengths == 0``.  Such a decode row is compared only with the JAX
``ref.py``: the Pallas kernel (like the port's CUDA kernel) returns zeros
there, the oracles return the uniform mean of the gathered values.
Tolerance: atol 2e-5, rtol 1e-5 (fp32 sums in another order).

Kernel 5 (dense selective attention over an explicit ``kv_pos``) runs on
the JAX package's own test shapes (``tests/test_kernels.py``): MHA, GQA,
MQA and a long cache with an ``INVALID_POS`` tail in fp32 and bf16,
windows 4/16/64, a ragged Sq/Skv, and permuted KV slots.  Tolerance: fp32
within 1e-5; bf16 within one bf16 ulp of the larger value plus
``2**-17 * max|V|`` (``repro_torch.kernels.check``): both sides sum in fp32
and round once.
"""
import numpy as np
import pytest
import torch

from repro.kernels.paged_attn.ops import paged_attention as jax_paged
from repro.kernels.selective_attn.ops import (
    selective_attention as jax_dense,
    selective_attention_paged as jax_selective,
)
from repro.kernels.selective_attn.ref import INVALID_POS as JAX_INVALID_POS
from repro_torch.kernels import KERNELS
from repro_torch.kernels.check import compare
from repro_torch.kernels.paged_attn.ops import paged_attention
from repro_torch.kernels.selective_attn.ops import (
    selective_attention,
    selective_attention_paged,
)
from repro_torch.kernels.selective_attn.ref import INVALID_POS

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


# -- kernel 5: dense selective attention --------------------------------------

def _dense_inputs(rng, b, sq, skv, hq, hkv, dh, invalid_tail=0):
    """The JAX tests' inputs (``tests/test_kernels.py::_mk``), fp32."""
    q = rng.normal(size=(b, sq, hq, dh)).astype(np.float32)
    k = rng.normal(size=(b, skv, hkv, dh)).astype(np.float32)
    v = rng.normal(size=(b, skv, hkv, dh)).astype(np.float32)
    kv_pos = np.tile(rng.permutation(skv).astype(np.int32), (b, 1))
    if invalid_tail:
        kv_pos[:, -invalid_tail:] = INVALID_POS
    qp = np.sort(rng.choice(skv, size=(sq,), replace=False)).astype(np.int32)
    return q, k, v, np.tile(qp, (b, 1)), kv_pos


def _dense_both(q, k, v, q_pos, kv_pos, window=0, dtype=np.float32):
    """(port, JAX Pallas in interpret mode, JAX ref) on the same inputs,
    cast to ``dtype`` (float32 or "bfloat16") before either sees them."""
    import jax.numpy as jnp
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jargs = [jnp.asarray(a, jdt) for a in (q, k, v)] + [q_pos, kv_pos]
    pallas = jax_dense(*jargs, window=window, block_q=8, block_k=16,
                       interpret=True)
    oracle = jax_dense(*jargs, window=window, use_ref=True)
    out = selective_attention(
        *[torch.from_numpy(a).to(tdt) for a in (q, k, v)],
        torch.from_numpy(q_pos), torch.from_numpy(kv_pos), window=window)
    return (out, torch.from_numpy(np.asarray(pallas, np.float32)),
            torch.from_numpy(np.asarray(oracle, np.float32)))


def test_invalid_pos_matches_reference():
    assert INVALID_POS == int(JAX_INVALID_POS)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,dh", [
    (1, 8, 16, 2, 2, 64),      # MHA
    (2, 16, 64, 4, 2, 64),     # GQA 2:1
    (1, 24, 48, 8, 1, 128),    # MQA, Dh=128
    (2, 8, 128, 4, 4, 32),     # long kv
])
def test_dense_plain_matches_pallas_sweep(b, sq, skv, hq, hkv, dh, dtype):
    rng = np.random.default_rng(0)
    args = _dense_inputs(rng, b, sq, skv, hq, hkv, dh, invalid_tail=skv // 4)
    out, pallas, oracle = _dense_both(*args, dtype=dtype)
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), pallas.numpy(), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(out.numpy(), oracle.numpy(), atol=1e-5,
                                   rtol=0)
    else:
        vmax = float(np.abs(args[2]).max())
        for other in (pallas, oracle):
            res = compare(out, other.to(torch.bfloat16), vmax)
            assert res["worst"] <= 1.0, res


@pytest.mark.parametrize("window", [4, 16, 64])
def test_dense_plain_matches_pallas_window(window):
    rng = np.random.default_rng(1)
    out, pallas, oracle = _dense_both(
        *_dense_inputs(rng, 2, 16, 64, 4, 2, 64), window=window)
    np.testing.assert_allclose(out.numpy(), pallas.numpy(), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(out.numpy(), oracle.numpy(), atol=1e-5,
                               rtol=0)


def test_dense_plain_matches_pallas_ragged():
    """Sq 13 and Skv 37: not multiples of the JAX blocks, which its wrapper
    pads and the port's kernel masks."""
    rng = np.random.default_rng(2)
    out, pallas, oracle = _dense_both(*_dense_inputs(rng, 1, 13, 37, 2, 2,
                                                     64))
    np.testing.assert_allclose(out.numpy(), pallas.numpy(), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(out.numpy(), oracle.numpy(), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dense_plain_kv_permutation(seed):
    """Permuting the KV slots with their positions changes nothing (the
    position-independence property) in either package."""
    rng = np.random.default_rng(seed)
    q, k, v, q_pos, kv_pos = _dense_inputs(rng, 1, 8, 32, 2, 2, 64)
    perm = rng.permutation(32)
    out1, pallas1, _ = _dense_both(q, k, v, q_pos, kv_pos)
    out2, pallas2, _ = _dense_both(q, k[:, perm], v[:, perm], q_pos,
                                   np.ascontiguousarray(kv_pos[:, perm]))
    np.testing.assert_allclose(out2.numpy(), out1.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(out2.numpy(), pallas2.numpy(), atol=1e-5,
                               rtol=0)


def test_dense_fully_masked_row_is_zero():
    """A query below every valid key: zeros, as the JAX kernel and ref."""
    rng = np.random.default_rng(3)
    q, k, v, q_pos, kv_pos = _dense_inputs(rng, 1, 4, 16, 2, 2, 32)
    kv_pos = kv_pos + 5
    q_pos[0, 0] = 2
    out, pallas, oracle = _dense_both(q, k, v, q_pos, kv_pos)
    assert torch.all(out[0, 0] == 0)
    np.testing.assert_allclose(out.numpy(), pallas.numpy(), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(out.numpy(), oracle.numpy(), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("window", [0, 16])
def test_dense_plain_log_sum_exp(window):
    """``selective_attention(..., return_lse=True)`` on the CPU (the plain
    version): the same output as without it, and each (query, head) row's
    log-sum-exp equal to ``torch.logsumexp`` of its kept scaled logits
    (fp32, within 1e-5), ``-inf`` where no key is kept; the log-sum-exps
    of two halves of the keys merge into the whole's, as the long decode's
    data ranks merge theirs."""
    rng = np.random.default_rng(4)
    q, k, v, q_pos, kv_pos = (torch.from_numpy(a) for a in _dense_inputs(
        rng, 2, 5, 40, 8, 2, 32))
    kv_pos = kv_pos + 5
    q_pos[0, 0] = 2
    out, lse = selective_attention(q, k, v, q_pos, kv_pos, window=window,
                                   return_lse=True)
    assert torch.equal(out, selective_attention(q, k, v, q_pos, kv_pos,
                                                window=window))
    assert lse.shape == q.shape[:3] and lse.dtype == torch.float32
    kk = torch.repeat_interleave(k, 4, dim=2)
    s = torch.einsum("bqhd,bkhd->bqhk", q.float(), kk.float()) / 32 ** 0.5
    kp, qp = kv_pos[:, None, None, :], q_pos[:, :, None, None]
    keep = (kp != INVALID_POS) & (kp <= qp)
    if window:
        keep = keep & (kp > qp - window)
    want = torch.logsumexp(s.masked_fill(~keep, -torch.inf), dim=-1)
    assert torch.equal(torch.isinf(lse), torch.isinf(want))
    assert torch.isinf(lse[0, 0]).all() and (lse[0, 0] < 0).all()
    live = ~torch.isinf(want)
    torch.testing.assert_close(lse[live], want[live], atol=1e-5, rtol=0)
    halves = [selective_attention(q, k[:, h], v[:, h], q_pos, kv_pos[:, h],
                                  window=window, return_lse=True)
              for h in (slice(0, 20), slice(20, 40))]
    merged = torch.logaddexp(halves[0][1], halves[1][1])
    torch.testing.assert_close(merged[live], lse[live], atol=1e-5, rtol=0)
