"""Dispatch for selective attention: the CUDA kernels on the card, the plain
versions on the CPU.

``selective_attention`` (dense, over an explicit ``kv_pos``) takes the
model's layout: q (B, Sq, Hq, Dh); k/v (B, Skv, Hkv, Dh); q_pos (B, Sq)
int32; kv_pos (B, Skv) int32 with ``INVALID_POS`` for an empty slot, in any
order.  It returns (B, Sq, Hq, Dh) in q's dtype.  A CPU tensor (and a
``meta`` one: the dry run's shapes) goes to
:func:`selective_attention_ref` (layout (B, H, S, Dh)); a CUDA tensor
launches ``sel_attn`` of ``csrc/selective_attn.cu``, which reads every
operand in place and masks both ragged edges itself (the JAX wrapper pads
to block multiples), or raises.  :func:`dense_route` picks one of three
routes from the host's shapes alone (never from the positions, which live
on the card):

- ``"tensor_cores"``: bf16 at head dim 64 or 128 with more than
  :data:`SPLIT_MAX_ROWS` (query, head) rows per (sequence, kv head): the
  uploads and every dense prefill.  Both products on ``mma.sync``, 128 rows
  of one kv head a block (64 when that makes less than a wave of blocks);
  steps of slots that no row of the block can see (by their ``kv_pos``)
  are never loaded.
- ``"split_keys"``: bf16 at head dim 64 or 128 with at most
  :data:`SPLIT_MAX_ROWS` such rows: the dense decode step.  The slots are
  cut into chunks of :data:`CHUNK` (:func:`plan_dense_splits`), one fp32
  partial per (row, chunk) goes to a workspace allocated here, and a second
  kernel that the same C call launches merges them.
- ``"cuda_cores"``: fp32, and bf16 at head dim 32: the first port, fp32
  math on the CUDA cores.

The bf16 routes copy 16-byte vectors, so q, k and v must be 16-byte
aligned (the wrapper raises otherwise).  Every call counts as one launch of
``SEL_ATTN`` and, in ``SEL_ATTN.route_launches``, one of its route.

``selective_attention_paged`` takes the model's layout: q (B, Sq, Hq, Dh);
pools (P, page_size, Hkv, Dh) of one layer; page_table (B, mp) int32; q_pos
(B, Sq) int32; lengths (B,) int32; optional k_scale/v_scale (P, Hkv) fp32
for the int8 pool.  It returns (B, Sq, Hq, Dh) in q's dtype.

A CPU tensor goes to :func:`selective_attention_paged_ref` (whose layout is
(B, Hq, Sq, Dh), as in the JAX package).  A CUDA tensor launches
``csrc/selective_attn.cu`` (``sel_attn_paged`` for a 16-bit pool,
``sel_attn_paged_q8`` for an int8 pool), which reads q and writes the
output in the model's layout and masks the ragged Sq edge itself, or
raises: there is no fallback on the card.  The source holds two kernels
behind each entry, chosen by q's dtype: bf16 goes to the tensor-core
kernel, which takes head dims 64 and 128 and copies 16-byte vectors (so q
and the pools must be 16-byte aligned); fp32 goes to the CUDA-core
kernel, any head dim.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels._build import Kernel, library, ptr
from repro_torch.kernels.paged_attn.ops import CHUNK
from repro_torch.kernels.selective_attn.ref import (
    selective_attention_paged_ref,
    selective_attention_ref,
)

_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
SEL_ATTN_PAGED = Kernel("sel_attn_paged", "selective_attn", _ARGS)
SEL_ATTN_PAGED_Q8 = Kernel("sel_attn_paged_q8", "selective_attn", _ARGS)
SEL_ATTN = Kernel("sel_attn", "selective_attn",
                  [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8)
KERNELS = (SEL_ATTN_PAGED, SEL_ATTN_PAGED_Q8, SEL_ATTN)

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
TENSOR_CORES, SPLIT_KEYS, CUDA_CORES = ("tensor_cores", "split_keys",
                                        "cuda_cores")
# the C entry of each bf16 route (the CUDA cores take sel_attn_<dtype>)
_ROUTE_ENTRY = {TENSOR_CORES: "mma_bf16", SPLIT_KEYS: "split_bf16"}
SPLIT_MAX_ROWS = 16     # (query, head) rows per (sequence, kv head)
MMA_HEAD_DIMS = (64, 128)


def dense_route(dtype, dh: int, sq: int, hq: int, hkv: int) -> str:
    """The route of a dense call, from shapes the host knows: bf16 at head
    dim 64 or 128 takes the split-key kernel when it has at most
    :data:`SPLIT_MAX_ROWS` (query, head) rows per (sequence, kv head), else
    the tensor-core kernel; anything else the CUDA-core kernel."""
    if dtype == torch.bfloat16 and dh in MMA_HEAD_DIMS:
        few = sq * (hq // hkv) <= SPLIT_MAX_ROWS
        return SPLIT_KEYS if few else TENSOR_CORES
    return CUDA_CORES


@dataclass(frozen=True)
class DenseSplitPlan:
    """How the split-key route cuts the slots: ``n_splits`` chunks of
    :data:`CHUNK` slots from slot 0, and the fp32 workspace of
    ``workspace_numel`` values that holds one partial ``(acc[Dh], m, l)``
    per (sequence, query, query head, split)."""
    n_splits: int
    workspace_numel: int
    skv: int

    def chunk_slots(self, split: int) -> range:
        """The slots split ``split`` reads, as the kernel computes them."""
        start = split * CHUNK
        return range(start, min(start + CHUNK, self.skv))


def plan_dense_splits(b: int, sq: int, hq: int, dh: int,
                      skv: int) -> DenseSplitPlan:
    """The split plan of a dense call, from its shapes alone (never from
    ``kv_pos``, which lives on the card).  Slots may hold positions in any
    order, so a window, which bounds positions, does not narrow it."""
    n_splits = max(1, -(-skv // CHUNK))
    return DenseSplitPlan(n_splits, b * sq * hq * n_splits * (dh + 2), skv)


def _check(cond: bool, what: str, name="selective_attention_paged") -> None:
    if not cond:
        raise ValueError(f"{name}: {what}")


def selective_attention(q, k, v, q_pos, kv_pos, *, window: int = 0,
                        return_lse: bool = False):
    """The dense selective attention (the module's notes); with
    ``return_lse`` also each (query, head) row's log-sum-exp of its kept
    scaled logits, (B, Sq, Hq) fp32, natural log, ``-inf`` for a row with
    no kept key: a long decode merges its ranks' slices of the keys with
    it.  On the card only the split-key and CUDA-core routes write it;
    asking the tensor-core route for it raises."""
    # meta runs no kernel: the plain version computes its shapes
    if q.device.type in ("cpu", "meta"):
        out = selective_attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), q_pos,
            kv_pos, window=window, return_lse=return_lse)
        if return_lse:
            return out[0].transpose(1, 2), out[1].transpose(1, 2)
        return out.transpose(1, 2)
    if q.device.type != "cuda":
        raise ValueError(f"selective_attention: unsupported device {q.device}")
    b, sq, hq, dh = q.shape
    _, skv, hkv, dh_k = k.shape
    tensors = [q, k, v, q_pos, kv_pos]

    def check(cond, what):
        _check(cond, what, "selective_attention")

    check(all(t.device == q.device for t in tensors),
          "all tensors must be on one device")
    check(all(t.is_contiguous() for t in tensors),
          "all tensors must be contiguous")
    check(q.dtype in _SUFFIX, f"q dtype {q.dtype} not float32/bfloat16")
    check(k.dtype == q.dtype and v.dtype == q.dtype,
          "k and v must have q's dtype")
    check(k.shape[0] == b and dh_k == dh and v.shape == k.shape,
          "k/v must be (B, Skv, Hkv, Dh) matching q")
    check(dh in (32, 64, 128), f"head dim {dh} not 32, 64 or 128")
    check(hq % hkv == 0, f"Hq {hq} not a multiple of Hkv {hkv}")
    check(q_pos.dtype == torch.int32 and q_pos.shape == (b, sq),
          "q_pos must be int32 (B, Sq)")
    check(kv_pos.dtype == torch.int32 and kv_pos.shape == (b, skv),
          "kv_pos must be int32 (B, Skv)")
    # the kernels read q, K and V rows as 16-byte vectors
    check(all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
          "q, k and v must be 16-byte aligned")
    out = torch.empty_like(q)
    route = dense_route(q.dtype, dh, sq, hq, hkv)
    check(not return_lse or route != TENSOR_CORES,
          f"the {route} route writes no log-sum-exp (the split-key and "
          "CUDA-core routes do)")
    lse = (torch.empty((b, sq, hq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if sq == 0:
        return (out, lse) if return_lse else out
    ws, n_splits = None, 0
    if route == SPLIT_KEYS:
        plan = plan_dense_splits(b, sq, hq, dh, skv)
        n_splits = plan.n_splits
        ws = torch.empty(plan.workspace_numel, dtype=torch.float32,
                         device=q.device)
    SEL_ATTN.launch(_ROUTE_ENTRY.get(route, _SUFFIX[q.dtype]), ptr(q),
                    ptr(k), ptr(v), ptr(q_pos), ptr(kv_pos),
                    None if ws is None else ptr(ws), ptr(out),
                    None if lse is None else ptr(lse), b, sq, skv,
                    hq, hkv, dh, int(window), n_splits, route=route)
    return (out, lse) if return_lse else out


def selective_attention_paged(q, k_pool, v_pool, page_table, q_pos, lengths,
                              *, k_scale=None, v_scale=None, window: int = 0):
    # meta runs no kernel: the plain version computes its shapes
    if q.device.type in ("cpu", "meta"):
        out = selective_attention_paged_ref(
            q.transpose(1, 2), k_pool, v_pool, page_table, q_pos, lengths,
            k_scale, v_scale, window=window)
        return out.transpose(1, 2)
    if q.device.type != "cuda":
        raise ValueError(
            f"selective_attention_paged: unsupported device {q.device}")
    quantized = k_scale is not None
    b, sq, hq, dh = q.shape
    p, ps, hkv, dh_k = k_pool.shape
    tensors = [q, k_pool, v_pool, page_table, q_pos, lengths]
    if quantized:
        tensors += [k_scale, v_scale]
    _check(all(t.device == q.device for t in tensors),
           "all tensors must be on one device")
    _check(all(t.is_contiguous() for t in tensors),
           "all tensors must be contiguous")
    _check(q.dtype in _SUFFIX, f"q dtype {q.dtype} not float32/bfloat16")
    _check(dh_k == dh and v_pool.shape == k_pool.shape,
           "pool shapes must be (P, page_size, Hkv, Dh) matching q")
    _check(hq % hkv == 0, f"Hq {hq} not a multiple of Hkv {hkv}")
    _check(page_table.dtype == torch.int32 and page_table.dim() == 2
           and page_table.shape[0] == b, "page_table must be int32 (B, mp)")
    _check(q_pos.dtype == torch.int32 and q_pos.shape == (b, sq),
           "q_pos must be int32 (B, Sq)")
    _check(lengths.dtype == torch.int32 and lengths.shape == (b,),
           "lengths must be int32 (B,)")
    if quantized:
        _check(v_scale is not None, "k_scale and v_scale go together")
        _check(k_pool.dtype == torch.int8 and v_pool.dtype == torch.int8,
               "scaled pools must be int8")
        _check(k_scale.dtype == torch.float32 and k_scale.shape == (p, hkv)
               and v_scale.shape == (p, hkv) and v_scale.dtype == torch.float32,
               "scales must be float32 (P, Hkv)")
        kernel, scales = SEL_ATTN_PAGED_Q8, (ptr(k_scale), ptr(v_scale))
    else:
        _check(k_pool.dtype == q.dtype and v_pool.dtype == q.dtype,
               "a 16-bit pool must have q's dtype")
        kernel, scales = SEL_ATTN_PAGED, (None, None)
    if q.dtype == torch.bfloat16:
        _check(dh in (64, 128),
               f"head dim {dh} not 64 or 128 (the bf16 kernel's)")
        # the bf16 kernel copies q and K/V rows as 16-byte vectors
        _check(all(t.data_ptr() % 16 == 0 for t in (q, k_pool, v_pool)),
               "q and the pools must be 16-byte aligned")
    out = torch.empty_like(q)
    if sq == 0:
        return out
    kernel.launch(_SUFFIX[q.dtype], ptr(q), ptr(k_pool), ptr(v_pool), *scales,
                  ptr(page_table), ptr(q_pos), ptr(lengths), ptr(out), b, sq,
                  hq, hkv, dh, ps, page_table.shape[1], int(window))
    return out


def paged_mma_resources(dh: int, quantized: bool) -> dict:
    """Registers, local memory per thread (bytes: spills and stack, 0 when
    nothing spills), static and dynamic shared memory (bytes), resident
    blocks per SM and threads per block of the bf16 tensor-core
    paged-prefill kernel for head dim ``dh``, as the card reports them
    (``cudaFuncGetAttributes`` and the occupancy calculator)."""
    fn = library("selective_attn").sel_attn_paged_mma_info
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * 6)()
    err = fn(dh, int(quantized), info)
    if err != 0:
        raise RuntimeError(f"sel_attn_paged_mma_info failed (cudaError {err})")
    keys = ("registers", "local_bytes", "static_smem_bytes", "smem_bytes",
            "blocks_per_sm", "threads")
    return dict(zip(keys, info))


def dense_resources(route: str, dh: int, arg: int,
                    block_rows: int = 128) -> dict:
    """Registers, local memory per thread (bytes: spills and stack, 0 when
    nothing spills), static and dynamic shared memory (bytes), resident
    blocks per SM, threads and (query, head) rows per block of a bf16 dense
    instantiation, as the card reports them (``cudaFuncGetAttributes`` and
    the occupancy calculator): the tensor-core kernel with ``block_rows``
    (128 or 64) rows a block for head dim ``dh`` and ``arg`` key slots (its
    shared memory grows with them), or the split-key kernel for ``arg``
    rows per (sequence, kv head)."""
    fn = library("selective_attn").sel_attn_dense_info
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * 7)()
    code = 1 if route == SPLIT_KEYS else {128: 0, 64: 2}[block_rows]
    err = fn(code, dh, arg, info)
    if err != 0:
        raise RuntimeError(f"sel_attn_dense_info failed (cudaError {err})")
    keys = ("registers", "local_bytes", "static_smem_bytes", "smem_bytes",
            "blocks_per_sm", "threads", "rows_per_block")
    return dict(zip(keys, info))
