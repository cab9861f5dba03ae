"""The dry run on the ``meta`` device (port of the JAX package's
``launch/dryrun.py``).

For every (architecture x input shape) it builds rank 0's shard of the
production mesh (``launch.mesh.make_production_mesh``: data 32 x model 8,
or pod 2 x data 32 x model 8) on ``meta`` with ``shard_params`` /
``local_config``, traces the step (``prefill``, ``mpic_prefill`` or
``decode``) through the port's own passes with rank 0's cut of the inputs
(its share of the batch on the batch axes, its kv heads on ``model``)
under a :class:`~repro_torch.launch.mesh.RecordingMesh`, and writes the
reference's row: the roofline terms of :func:`repro_torch.roofline.
step_cost`'s least work (the port has no XLA cost model), the recorded
collectives' wire bytes, and the bytes the shard, its cache and its inputs
hold.  Not a byte is allocated: a 76B step traces on a CPU-only machine.
The run's device is ``meta`` by nature; nothing here touches a card.

A decode whose batch no data axis divides (``long_500k``'s batch of 1)
puts its KV sequence on ``data``: rank 0 holds ``kv_len / 32`` slots of
the ring and merges its slice's attention with the other data ranks'
through kernel 5's log-sum-exp (two fp32 all-reduces a layer on
``data``, recorded beside the ``model`` axis's).

Rows are ``ok`` or ``skipped`` with the reason, never ``error``:

* where the reference's ``step_kind`` skips the shape;
* ``train_4k`` under a mesh (ROADMAP.md queue 1: training under a mesh
  is the next slice).

``--serving-selftest`` traces ``serve_decode`` and ``serve_prefill`` on
the paged pool and the dense decode step at ``model 8`` and asserts that
rank 0's pool and dense cache hold ``Hkv / 8`` kv heads in and out of each
step, and that the recorded collectives are the plan's: a vocab-parallel
embedding's all-reduce, two fp32 all-reduces a layer (the row products)
and the vocab gather; then ``serve_decode`` on ``data 32 x model 8``,
where rank 0 decodes its 1/32 of the slots and the step adds the data
gathers of every slot's new K/V rows and logits.  An int8 pool is
counted analytically and not traced: its quantizing scatter
(``cache/pagequant.py``) calls ``torch.unique``, whose size depends on
the data (ROADMAP.md queue 1 item 2(a)).

Usage::

  python -m repro_torch.launch.dryrun --arch internvl2-76b --shape decode_32k
  python -m repro_torch.launch.dryrun --all --out dryrun.json
  python -m repro_torch.launch.dryrun --all --multi-pod
  python -m repro_torch.launch.dryrun --serving-selftest
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import (
    Collective,
    RecordingMesh,
    make_production_mesh,
)
from repro_torch.roofline.analysis import (
    Row,
    collective_bytes,
    model_flops,
    step_cost,
)

QUEUE_ITEM_6_TRAIN = ("training under a mesh (FSDP on the data axis) is "
                      "not ported: the next slice (ROADMAP.md queue 1 "
                      "item 6)")
INT8_ANALYTIC = ("counted analytically, not traced: the int8 pool's "
                 "quantizing scatter calls torch.unique, whose size depends "
                 "on the data (ROADMAP.md queue 1 item 2(a))")


def _nbytes(tree) -> int:
    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_nbytes(v) for v in tree)
    return 0


def _skip(arch, shape_name, mesh_name, reason) -> dict:
    return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "step": "skip", "status": "skipped", "reason": reason}


def shard_on_meta(cfg, mesh: RecordingMesh):
    """Rank ``mesh.rank``'s shard of ``cfg`` on ``meta``, its plan set:
    ``shard_params`` of a whole ``meta`` model, ``local_config``'s
    shapes."""
    from repro_torch.models.transformer import Transformer
    from repro_torch.serving.sharding import ServingSharding
    sh = ServingSharding(mesh, cfg)
    shard = S.shard_params(Transformer(cfg, device="meta"), mesh, sh.specs)
    shard.sharding = sh
    return shard, sh


def _rows(kind: str, batch: int, seq: int, kv_len: int):
    """Rank 0's rows of the least work: a prefill's whole sequences, a
    decode step at the cache's last slot, an mpic prefill's selection
    spread evenly (the last of every ``1 / MPIC_SEL_FRAC`` positions: the
    reference's inputs hold no positions)."""
    if kind == "prefill":
        return [Row(np.arange(seq), seq)] * batch
    if kind == "decode":
        return [Row([kv_len - 1], kv_len)] * batch
    stride = int(round(1 / S.MPIC_SEL_FRAC))
    n = max(int(seq * S.MPIC_SEL_FRAC), 1)
    return [Row(np.arange(n) * stride + stride - 1, seq)] * batch


def _rows_of(kind: str, local_args) -> int:
    if kind == "prefill":
        return local_args[0]["tokens"].shape[0]
    if kind == "decode":
        return local_args[-1].shape[0]
    return local_args[0]["sel_tokens"].shape[0]


def trace_step(cfg, kind: str, shape, mesh):
    """Trace ``kind`` on rank 0 of ``mesh`` (axis names and sizes, as
    :func:`make_production_mesh` gives them) on ``meta``: its shard, its
    cut of :func:`~repro_torch.launch.specs.input_specs`' inputs, the
    port's pass under a ``RecordingMesh`` of the ``model`` axis.  Returns
    ``(local inputs, output, collectives, shard, plan)``; raises where
    rank 0's dense cache is not its cut (its rows, its kv heads)."""
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    tp = RecordingMesh(model=sizes["model"], rank=0, data=sizes["data"])
    shard, sh = shard_on_meta(cfg, tp)
    args, specs = S.input_specs(cfg, shape, kind, mesh)
    # only the dense cache has "model" dimensions (the reference's): the
    # port cuts its kv heads where attention is cut and its SSM state
    # where the SSD heads are
    specs = tuple(S.rank_cache_pspecs(cfg, mesh, sp, sh.cuts)
                  if isinstance(sp, dict) and set(sp) & {"k", "ssm_h"}
                  else sp for sp in specs)
    local_args = S.localize(args, specs, mesh)
    fn = S.make_step_fn(sh.local_cfg, kind, shape, sh.local_model())
    with torch.no_grad():
        out = fn(shard, *local_args)
    for a in local_args:
        if isinstance(a, dict) and "k" in a:
            want = (_rows_of(kind, local_args), sh.local_cfg.num_kv_heads)
            for t in (a["k"], a["v"]):
                if (t.shape[1], t.shape[3]) != want:
                    raise AssertionError(
                        f"{cfg.name} {kind}: rank 0's cache "
                        f"{tuple(t.shape)} is not its cut (rows, kv heads "
                        f"{want})")
    return local_args, out, list(tp.calls), shard, sh


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            step_override: str | None = None) -> dict:
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    kind = step_override or S.step_kind(cfg, shape)
    mesh = make_production_mesh(multi_pod=multi_pod)
    if kind is None:
        return _skip(arch, shape_name, mesh.name,
                     "no sub-quadratic decode path (the reference's "
                     "step_kind)")
    if kind == "train":
        return _skip(arch, shape_name, mesh.name, QUEUE_ITEM_6_TRAIN)

    t0 = time.perf_counter()
    local_args, out, calls, shard, sh = trace_step(cfg, kind, shape, mesh)
    trace_s = time.perf_counter() - t0
    local = sh.local_cfg
    cache = next((a for a in local_args if isinstance(a, dict) and "k" in a),
                 None)
    rows_b = _rows_of(kind, local_args)
    kv_len = (S.decode_kv_len(cfg, shape) if kind == "decode"
              else shape.seq_len)
    if kind == "decode" and cache is not None:
        kv_len = cache["k"].shape[2]        # a data rank's slice of the ring
    cost = step_cost(local, _rows(kind, rows_b, shape.seq_len, kv_len),
                     widths=sh.widths)
    params_b = _nbytes(list(shard.parameters()))
    # a prefill builds its cache inside the step
    cache_b = _nbytes(cache if cache is not None else
                      sh.local_model().make_cache(rows_b, shape.seq_len,
                                                  device="meta"))
    coll = collective_bytes(calls)
    rl = cost.roofline(arch, shape_name, mesh.name, kind, chips=mesh.size,
                       model_flops_global=model_flops(cfg, shape, kind),
                       coll=coll)
    rl.memory_per_device = {
        "params": params_b, "cache": cache_b,
        "inputs": _nbytes(local_args) - _nbytes(cache),
        "outputs": _nbytes(out),
        "arguments": params_b + _nbytes(local_args)}
    row = rl.to_dict()
    row.update(status="ok", lower_s=round(trace_s, 2), compile_s=None,
               coll_ops=len(calls), device="meta",
               coll_ops_by_axis={a: sum(c.axis == a for c in calls)
                                 for a in sorted(coll.by_axis)},
               coll_bytes_by_axis=coll.by_axis,
               counted="least work (roofline.step_cost) of rank 0's cut; "
                       "collectives recorded on the model and data axes")
    print(f"[{arch} x {shape_name} x {mesh.name}] step={kind} "
          f"trace={trace_s:.1f}s Tc={rl.t_compute * 1e3:.2f}ms "
          f"Tm={rl.t_memory * 1e3:.2f}ms "
          f"Tcoll={rl.t_collective * 1e3:.2f}ms -> {rl.bottleneck} "
          f"useful={rl.useful_flops_ratio:.2f} "
          f"({len(calls)} collectives)", flush=True)
    return row


# ---------------------------------------------------------------------------
# the serving steps: traced on meta, layout asserted
# ---------------------------------------------------------------------------

def trace_serving(cfg, kind: str, mesh: RecordingMesh, *, slots: int = 16,
                  kv_len: int = 256, s_sel: int | None = None):
    """Trace ``kind`` (``serve_decode`` / ``serve_prefill``) on rank
    ``mesh.rank``'s shard of ``cfg`` (a ``meta`` ``RecordingMesh``), the
    counterpart of the reference's ``lower_serving``.  Returns ``(inputs,
    output, calls)``: rank 0's inputs (the pool first), the step's logits
    and the collectives it ran."""
    shard, sh = shard_on_meta(cfg, mesh)
    args, specs = S.serving_input_specs(cfg, mesh, slots=slots,
                                        kv_len=kv_len, kind=kind,
                                        s_sel=s_sel)
    local = S.localize(args, specs, mesh)
    fn = S.make_serving_step_fn(sh.local_cfg, kind)
    del mesh.calls[:]
    with torch.no_grad():
        out = fn(shard, *local)
    return local, out, list(mesh.calls)


def plan_collectives(cfg, mesh, rows: int, tokens: int) -> list:
    """The collectives one serving pass of ``rows x tokens`` tokens runs
    under ``ServingSharding``'s plan: the embedding's all-reduce (in the
    compute dtype) where the vocabulary is cut, an fp32 all-reduce after
    each cut row product (the attention's output where attention is cut,
    the MLP's down projection where it is), the logits' vocab gather
    (fp32)."""
    from repro_torch.device import torch_dtype
    from repro_torch.serving.sharding import ServingSharding
    sh = ServingSharding(mesh, cfg)
    m, d = mesh.model, cfg.d_model
    item = torch.tensor([], dtype=torch_dtype(cfg.compute_dtype)
                        ).element_size()
    t = rows * tokens
    out = []
    if sh.vocab:
        out.append(Collective("all-reduce", t * d * item, m))
    per_layer = [Collective("all-reduce", t * d * 4, m)] * (
        int(sh.attn) + int(sh.mlp))
    out += per_layer * cfg.num_layers
    if sh.vocab:
        out.append(Collective("all-gather", t * cfg.vocab_size * 4, m))
    return out


SELFTEST_CONFIG = ModelConfig(
    name="serve-selftest", arch_type="dense", num_layers=2, d_model=128,
    num_heads=16, num_kv_heads=16, head_dim=8, d_ff=256, vocab_size=2048)


def serving_selftest() -> int:
    """The serving layout at ``model 8`` on ``meta``: for a small config
    with 16 kv heads, rank 0's pool keeps 2 heads through ``serve_decode``
    and ``serve_prefill`` and its dense cache through the dense decode
    step, and each step runs exactly the plan's collectives."""
    cfg = SELFTEST_CONFIG
    model = make_production_mesh().shape[-1]
    mesh = RecordingMesh(model=model, rank=0)
    heads = cfg.num_kv_heads // model
    slots, kv_len = 16, 256
    for kind in ("serve_decode", "serve_prefill"):
        t0 = time.perf_counter()
        local, out, calls = trace_serving(cfg, kind, mesh, slots=slots,
                                          kv_len=kv_len)
        pool_k, pool_v = local[0], local[1]
        for pool in (pool_k, pool_v):
            assert pool.shape[3] == heads, (
                f"{kind}: the pool holds {pool.shape[3]} kv heads, the "
                f"rank's cut is {heads}")
        tokens = local[2].shape[1]
        want = plan_collectives(cfg, mesh, local[2].shape[0], tokens)
        assert calls == want, f"{kind}: collectives {calls}, plan {want}"
        assert out.shape[-1] == cfg.vocab_size, (
            f"{kind}: logits {tuple(out.shape)} are not the whole "
            "vocabulary")
        print(f"[{kind}] model {model}: pool {tuple(pool_k.shape)} "
              f"({heads} of {cfg.num_kv_heads} kv heads) in and out, "
              f"{len(calls)} collectives as planned, "
              f"trace={time.perf_counter() - t0:.2f}s", flush=True)
    # the int8 pool: the same steps counted, not traced
    local = shard_on_meta(cfg, mesh)[1].local_cfg
    for kind, rows in (("serve_decode", [Row([kv_len - 1], kv_len)] * slots),
                       ("serve_prefill", _rows("mpic_prefill", 1, kv_len,
                                               kv_len))):
        bf16, int8 = (step_cost(local, rows, kv_dtype=dt)
                      for dt in (None, "int8"))
        print(f"[{kind}, int8 pool] KV bytes {int8.kv_bytes:.0f} "
              f"against {bf16.kv_bytes:.0f} on a "
              f"{local.compute_dtype} pool; {INT8_ANALYTIC}", flush=True)
    # the dense cache through the dense decode step
    shape = dataclasses.replace(INPUT_SHAPES["decode_32k"], seq_len=kv_len,
                                global_batch=slots)
    shard, sh = shard_on_meta(cfg, mesh)
    del mesh.calls[:]
    cache = sh.local_model().make_cache(slots, kv_len, device="meta")
    tok = torch.empty((slots, 1), dtype=torch.int32, device="meta")
    fn = S.make_step_fn(sh.local_cfg, "decode", shape)
    with torch.no_grad():
        logits, cache = fn(shard, cache, tok, tok)
    for key in ("k", "v"):
        assert cache[key].shape[3] == heads, (
            f"decode: the dense cache holds {cache[key].shape[3]} kv heads")
    assert mesh.calls == plan_collectives(cfg, mesh, slots, 1)
    print(f"[decode] model {model}: dense cache "
          f"{tuple(cache['k'].shape)} in and out, {len(mesh.calls)} "
          "collectives as planned", flush=True)
    # the data axis: rank 0 of data 32 x model 8 decodes its slots, then
    # gathers every slot's new K/V rows and logits over data
    data = make_production_mesh().shape[0]
    dmesh = RecordingMesh(model=model, rank=0, data=data)
    local, out, calls = trace_serving(cfg, "serve_decode", dmesh,
                                      slots=data * 2, kv_len=kv_len)
    rows = local[2].shape[0]
    want = plan_collectives(cfg, dmesh, rows, 1)
    assert rows == 2 and calls == plan_data_collectives(
        cfg, dmesh, want, data * 2), f"serve_decode on data: {calls}"
    assert out.shape == (data * 2, cfg.vocab_size)
    print(f"[serve_decode] data {data} x model {model}: rank 0 decodes "
          f"{rows} of {data * 2} slots, {len(calls)} collectives, "
          f"{sum(c.axis == 'data' for c in calls)} of them on data",
          flush=True)
    print("serving selftest OK")
    return 0


def plan_data_collectives(cfg, mesh, model_calls: list, slots: int) -> list:
    """A data rank's paged decode step: the plan's ``model`` collectives
    over its slots, then the ``data`` gathers of every slot's new K/V rows
    (K and V of every layer, the rank's kv heads, in the compute dtype)
    and of the logits (fp32)."""
    from repro_torch.device import torch_dtype
    from repro_torch.serving.sharding import ServingSharding
    local = ServingSharding(mesh, cfg).local_cfg
    item = torch.tensor([], dtype=torch_dtype(cfg.compute_dtype)
                        ).element_size()
    d = mesh.data
    kv = (2 * cfg.num_layers * slots * local.num_kv_heads * cfg.head_dim
          * item)
    return model_calls + [
        Collective("all-gather", kv, d, "data"),
        Collective("all-gather", slots * cfg.vocab_size * 4, d, "data")]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--step", default=None,
                    help="override the step kind (e.g. mpic_prefill)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--serving-selftest", action="store_true",
                    help="trace the sharded serving steps at model 8 on "
                         "meta and assert the pool's cut and the "
                         "collectives")
    args = ap.parse_args(argv)

    if args.serving_selftest:
        return serving_selftest()
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    results = []
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    def done_key(r):
        return (r["arch"], r["shape"], r.get("mesh", ""), r.get("step", ""))

    have = {done_key(r) for r in results} if args.skip_existing else set()
    combos = ([(a, s) for a in ASSIGNED_ARCHS for s in INPUT_SHAPES]
              if args.all else [(args.arch, args.shape)])
    mesh_name = make_production_mesh(multi_pod=args.multi_pod).name
    for arch, shape_name in combos:
        kind = args.step or S.step_kind(get_config(arch),
                                        INPUT_SHAPES[shape_name])
        if (arch, shape_name, mesh_name, kind or "skip") in have:
            continue
        r = run_one(arch, shape_name, multi_pod=args.multi_pod,
                    step_override=args.step)
        if r["status"] == "skipped":
            print(f"[{arch} x {shape_name} x {mesh_name}] skipped: "
                  f"{r['reason']}", flush=True)
        results.append(r)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)

    ok = sum(1 for r in results if r.get("status") == "ok")
    sk = sum(1 for r in results if r.get("status") == "skipped")
    err = sum(1 for r in results if r.get("status") == "error")
    print(f"\ndry-run: {ok} ok, {sk} skipped, {err} errors")
    return 0 if err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
