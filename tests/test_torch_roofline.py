"""The port's cost model against the JAX package's: parameter counts, the
6ND model FLOPs, the input shapes and step kinds, the wire-bytes model,
the ``Roofline`` terms, the dense cache's specs and the Fig. 6 transfer
plan, equal to the reference's; ``step_cost``'s FLOPs against XLA's
``cost_analysis()`` of the reference's step and against
``FlopCounterMode`` on the port's plain path.

Tolerances: everything but the XLA comparison is exact.  XLA counts the
masked half of the causal S x S attention and the elementwise work
(norms, softmax, RoPE, activations) that the analytic least work leaves
out, so its count is at least ``step_cost``'s and, at d_model 512 with 16
tokens a row (the products dominate), at most 2 % above it (0.2-0.4 %
at these shapes).
"""
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.cache import KVLibrary as JaxLibrary
from repro.cache import plan_transfers as jax_plan_transfers
from repro.configs import ASSIGNED_ARCHS as JAX_ARCHS
from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_config
from repro.configs.base import ModelConfig as JaxConfig
from repro.launch import mesh as jax_mesh
from repro.launch import specs as jax_specs
from repro.roofline import analysis as jax_rl
from repro_torch.cache import KVLibrary, plan_transfers
from repro_torch.cache.backends import TIER_BW
from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import specs
from repro_torch.models import build_model
from repro_torch.models.transformer import Transformer
from repro_torch.roofline import analysis as rl
from repro_torch.roofline.analysis import Row, step_cost

from _torch_parity import jax_compile_cache  # noqa: F401

ALL_ARCHS = ASSIGNED_ARCHS + ["llava-1.6-7b"]
KINDS = ("train", "prefill", "decode", "mpic_prefill")
WIRE_KINDS = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all",
              "collective-permute")
# a width at which the products dominate the step (see the docstring)
COST = dict(name="cost", arch_type="dense", d_model=512, num_heads=8,
            num_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=1024,
            param_dtype="float32", compute_dtype="float32")
XLA_REL = 0.02
B, S = 2, 16


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_parameter_counts_are_the_references(arch):
    ours, ref = get_config(arch), jax_config(arch)
    assert ours.n_params() == ref.n_params()
    assert ours.n_active_params() == ref.n_active_params()


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_model_flops_are_the_references(arch):
    for shape in INPUT_SHAPES:
        for kind in KINDS:
            assert rl.model_flops(get_config(arch), INPUT_SHAPES[shape],
                                  kind) == jax_rl.model_flops(
                jax_config(arch), JAX_SHAPES[shape], kind), (shape, kind)


def test_input_shapes_and_archs_are_the_references():
    assert ASSIGNED_ARCHS == JAX_ARCHS
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_step_kind_and_decode_kv_len_are_the_references(arch):
    for name, shape in INPUT_SHAPES.items():
        ref_shape = JAX_SHAPES[name]
        assert specs.step_kind(get_config(arch), shape) == \
            jax_specs.step_kind(jax_config(arch), ref_shape), name
        assert specs.decode_kv_len(get_config(arch), shape) == \
            jax_specs.decode_kv_len(jax_config(arch), ref_shape), name


@pytest.mark.parametrize("kind", WIRE_KINDS)
def test_wire_bytes_are_the_references(kind):
    for g in range(2, 17):
        for nbytes in (1, 4096, 12345, 1 << 30):
            assert rl._wire_bytes(kind, nbytes, g) == \
                jax_rl._wire_bytes(kind, nbytes, g)


def test_collective_bytes_sum_the_calls():
    calls = [port_mesh.Collective("all-reduce", 4096, 8)] * 3 + [
        port_mesh.Collective("all-gather", 1000, 4)]
    stats = rl.collective_bytes(calls)
    assert stats.op_count == 4
    assert stats.by_kind == {"all-reduce": 3 * 2 * 4096 * 7 / 8,
                             "all-gather": 1000 * 3 / 4}
    assert stats.total_bytes == sum(stats.by_kind.values())


def test_roofline_terms_and_keys_are_the_references():
    kw = dict(arch="yi-9b", shape="decode_32k", mesh="m", step="decode",
              flops_per_device=3.0e12, bytes_per_device=7.0e9,
              coll_bytes_per_device=2.0e8, model_flops_global=5.0e14,
              chips=256, coll_by_kind={"all-reduce": 2.0e8},
              memory_per_device={"params": 1})
    ours, ref = rl.Roofline(**kw), jax_rl.Roofline(**kw)
    assert ours.t_compute * port_mesh.H100_PEAK_FLOPS_BF16 == pytest.approx(
        ref.t_compute * jax_mesh.PEAK_FLOPS_BF16, rel=1e-15)
    assert ours.t_memory * port_mesh.H100_HBM_BW == pytest.approx(
        ref.t_memory * jax_mesh.HBM_BW, rel=1e-15)
    assert ours.t_collective * port_mesh.H100_NVLINK_BW == pytest.approx(
        ref.t_collective * jax_mesh.ICI_BW, rel=1e-15)
    assert ours.useful_flops_ratio == ref.useful_flops_ratio
    assert ours.to_dict().keys() == ref.to_dict().keys()
    terms = {"compute": ours.t_compute, "memory": ours.t_memory,
             "collective": ours.t_collective}
    assert ours.bottleneck == max(terms, key=terms.get)
    assert rl.least_time(ours) == max(terms.values())
    assert rl.roofline_share(2 * max(terms.values()), ours) == 0.5
    assert rl.mfu(1.0, port_mesh.H100_PEAK_FLOPS_BF16, 2) == 0.5


def _stand_in(shape):
    """A mesh with what both packages' spec functions read."""
    names = ("pod", "data", "model")[-len(shape):]
    return types.SimpleNamespace(axis_names=names, shape=shape,
                                 devices=np.empty(shape))


@pytest.mark.parametrize("mesh_shape", [(32, 8), (2, 32, 8), (16, 16),
                                        (1, 2)])
def test_cache_pspecs_and_dims_are_the_references(mesh_shape):
    mesh = _stand_in(mesh_shape)
    for arch in ALL_ARCHS:
        cfg, ref_cfg = get_config(arch), jax_config(arch)
        for name, shape in INPUT_SHAPES.items():
            ours = specs._dims(cfg, shape, mesh)
            ref = jax_specs._dims(ref_cfg, JAX_SHAPES[name], mesh)
            assert ours == ref, (arch, name)
            got = specs.cache_pspecs(cfg, mesh, *ours[:2])
            want = jax_specs.cache_pspecs(ref_cfg, mesh, *ref[:2])
            assert got == {k: tuple(v) for k, v in want.items()}, (arch,
                                                                   name)


def test_production_mesh_and_rules():
    mesh = port_mesh.make_production_mesh()
    assert (mesh.axis_names, mesh.shape, mesh.size) == (
        ("data", "model"), (32, 8), 256)
    pods = port_mesh.make_production_mesh(multi_pod=True)
    assert (pods.axis_names, pods.size, pods.name) == (
        ("pod", "data", "model"), 512, "2x32x8")
    for multi_pod in (False, True):
        assert port_mesh.activation_rules(multi_pod=multi_pod) == \
            jax_mesh.activation_rules(multi_pod=multi_pod)
    assert port_mesh.activation_rules() == jax_mesh.serving_rules()


@pytest.mark.parametrize("arch", ["internvl2-76b", "deepseek-moe-16b",
                                  "mamba2-130m", "whisper-small"])
def test_fsdp_leaf_specs_are_the_references(arch):
    from repro_torch.weights import leaf_path
    for name, p in specs._meta_params(get_config(arch)).named_parameters():
        path, index = leaf_path(name)
        ndim = p.dim() + (index is not None)
        ref_path = "/" + "/".join(path)
        assert specs.leaf_spec(ref_path, ndim, fsdp=True) == tuple(
            jax_specs._leaf_spec(ref_path, ndim, fsdp=True)), name


def _kv(nbytes):
    n = nbytes // 8
    return (np.zeros((1, n // 16, 2, 8), np.float32),
            np.zeros((1, n // 16, 2, 8), np.float32))


@pytest.mark.parametrize("caps", [{}, {"hbm_capacity": 1 << 16,
                                       "host_capacity": 1 << 16}],
                         ids=["memory", "host_and_disk"])
def test_plan_transfers_is_the_references(tmp_path, caps):
    """The reference's case (two hits, two misses at 10 ms each), and the
    same with capacities that push blocks to the host and the disk."""
    k, v = _kv(1 << 16)
    ref = JaxLibrary(spool_dir=str(tmp_path / "jax"), **caps)
    ours = KVLibrary(spool_dir=str(tmp_path / "port"), device="cpu", **caps)
    for i, name in enumerate(("hit1", "hit2", "hit3")):
        ref.put("u", name, k + i, v)
        ours.put("u", name, torch.from_numpy(k + i), torch.from_numpy(v))
    ids = ["hit1", "hit2", "hit3", "miss1", "miss2"]
    want = jax_plan_transfers(ref, "u", ids,
                              compute_estimator=lambda m: 0.010)
    got = plan_transfers(ours, "u", ids, compute_estimator=lambda m: 0.010)
    assert got.hits == want.hits and got.misses == want.misses
    assert got.compute_s == want.compute_s == pytest.approx(0.020)
    assert got.load_s == sum(n / TIER_BW[t] for _, t, n in got.hits)
    assert got.parallel_s == max(got.load_s, got.compute_s)
    assert got.sequential_s == got.load_s + got.compute_s
    if caps:
        assert {t for _, t, _ in got.hits} >= {"host", "disk"}


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_step_cost_against_xla_cost_analysis(kind):
    """The reference's step at L = 1 and 2 (as its ``_extrapolated_cost``
    compiles it), one CPU device: XLA's FLOPs within ``XLA_REL`` above the
    analytic least work, and so the per-layer difference."""
    shape = JAX_SHAPES["decode_32k"].__class__("cost", S, B, kind)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    rows = ([Row(np.arange(S), S)] * B if kind == "prefill"
            else [Row([S - 1], S)] * B)
    xla, ours = [], []
    for layers in (1, 2):
        jcfg = JaxConfig(num_layers=layers, scan_layers=False, **COST)
        model, _, fn = jax_specs.make_step_fn(jcfg, kind, shape)
        params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        args, _ = jax_specs.input_specs(jcfg, shape, kind, mesh)
        cost = jax.jit(fn).lower(params, *args).compile().cost_analysis()
        xla.append(float(cost["flops"]))
        ours.append(step_cost(ModelConfig(num_layers=layers, **COST),
                              rows).flops)
    for x, o in [*zip(xla, ours), (xla[1] - xla[0], ours[1] - ours[0])]:
        assert o <= x <= o * (1 + XLA_REL), (xla, ours)


def test_step_cost_products_equal_flop_counter_on_the_plain_path():
    """Every product with a weight (and the head) counted exactly as
    ``FlopCounterMode`` counts the port's plain prefill and decode (its
    ``mm``; on ``meta``, which runs the plain versions); its attention
    (``bmm``) sweeps every slot, the least work only the causal pairs."""
    cfg = ModelConfig(num_layers=2, **COST)
    model = build_model(cfg)
    params = Transformer(cfg, device="meta")    # counts need no values
    tokens = torch.empty((B, S), dtype=torch.int32, device="meta")
    attn = 4 * cfg.head_dim * cfg.num_heads * cfg.num_layers * B
    with FlopCounterMode(display=False) as fc:
        model.prefill(params, tokens, model.make_cache(B, S, device="meta"))
    counts = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    cost = step_cost(cfg, [Row(np.arange(S), S)] * B)
    assert counts["aten.mm"] == cost.weight_flops
    assert counts["aten.bmm"] == attn * S * S
    assert cost.attn_flops == attn * S * (S + 1) // 2
    pos = tokens[:, :1]
    with FlopCounterMode(display=False) as fc:
        model.decode_step(params, tokens[:, :1], pos,
                          model.make_cache(B, S, device="meta"), pos)
    counts = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    cost = step_cost(cfg, [Row([S - 1], S)] * B)
    assert counts["aten.mm"] == cost.weight_flops
    assert counts["aten.bmm"] == cost.attn_flops == attn * S


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mamba2-130m",
                                  "hymba-1.5b"])
def test_a_ranks_step_cost_counts_its_shard(arch):
    """Rank 0 of a 2-wide ``model`` axis at full width (2 layers), its
    prefill traced on ``meta``: its products with the weights as
    ``FlopCounterMode`` counts them (a MoE's routed experts aside: a rank
    does ``k x experts / E`` of the pairs a token on average), its
    weights' bytes its shard's (the leaves it holds whole, whole: the
    router, ``bc_proj``, hymba's replicated SSM), its SSM state its heads'
    and channels'."""
    from repro_torch.launch.dryrun import shard_on_meta
    cfg = dataclasses.replace(get_config(arch), num_layers=2)
    shard, sh = shard_on_meta(cfg, port_mesh.RecordingMesh(model=2))
    local, w = sh.local_model(), sh.widths
    s = 128
    tokens = torch.empty((1, s), dtype=torch.int32, device="meta")
    cache = local.make_cache(1, s + 1, device="meta")
    with FlopCounterMode(display=False) as fc:
        local.prefill(shard, tokens, cache)
    counts = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    cost = step_cost(sh.local_cfg, [Row(np.arange(s), s)], widths=w)
    experts = 0
    if cfg.num_experts:
        assert w.experts == cfg.num_experts // 2
        experts = 2 * s * cfg.experts_per_token * w.experts \
            / cfg.num_experts * sum(
                p[0].numel() for n, p in shard.named_parameters()
                if ".moe.w_" in n)
    assert counts["aten.mm"] == pytest.approx(cost.weight_flops - experts,
                                              rel=1e-12)
    item = {"bfloat16": 2, "float32": 4}
    held = sum(p.numel() * (4 if n.rsplit(".", 1)[-1] in (
                                "router", "dt_bias", "A_log", "D")
                            else item[cfg.param_dtype])
               for n, p in shard.named_parameters() if n != "embed")
    if cfg.tie_embeddings:
        held += shard.embed.numel() * item[cfg.param_dtype]
    assert cost.weight_bytes == held
    if cfg.ssm_state:
        assert cost.state_bytes == cfg.num_layers * (
            cache["ssm_h"][0, 0].numel() * 4
            + cache["ssm_conv"][0, 0].numel() * item[cfg.compute_dtype])


def _brute_pairs(q_pos, keys, window):
    keys = np.arange(keys) if np.ndim(keys) == 0 else np.asarray(keys)
    q = np.asarray(q_pos)[:, None]
    m = keys[None, :] <= q
    if window > 0:
        m &= keys[None, :] > q - window
    return int(m.sum()), int(m.any(0).sum())


@pytest.mark.parametrize("window", [0, 5, 64])
def test_kept_pairs_and_keys_equal_a_brute_force_mask(window):
    rng = np.random.default_rng(window)
    for _ in range(20):
        n = int(rng.integers(1, 200))
        q = np.sort(rng.choice(n, size=int(rng.integers(1, n + 1)),
                               replace=False))
        keys = np.sort(rng.choice(400, size=n, replace=False))
        for k in (n, keys):
            qq = q if np.ndim(k) == 0 else keys[q]
            pairs, seen = rl._visible(qq, k, window)
            assert (pairs, seen.size) == _brute_pairs(qq, k, window)
        lens = rng.integers(0, 300, 8)
        want = [_brute_pairs([max(n_ - 1, 0)], n_, window)[0] if n_ else 0
                for n_ in lens]
        assert rl.valid_keys_decode(lens, 16, 32, window).tolist() == [
            min(w, 512) for w in want]
        assert rl.valid_keys_prefill(q, n, window).sum() == \
            _brute_pairs(q, n, window)[0]


def test_step_cost_counts_what_the_step_needs():
    """Weights once a step, KV read once and written once (int8: a byte
    and the touched pages' scale rows), the window's keys only, a MoE's
    routed experts, an SSM's state; training three times the products."""
    cfg = get_config("llava-1.6-7b")
    L, kvd = cfg.num_layers, cfg.kv_dim
    one = step_cost(cfg, [Row([99], 100)])
    two = step_cost(cfg, [Row([99], 100)] * 2)
    assert two.weight_bytes == one.weight_bytes
    assert two.kv_bytes == 2 * one.kv_bytes
    assert one.kv_bytes == 2 * 100 * kvd * 2 * L           # 99 read, 1 new
    q8 = step_cost(cfg, [Row([99], 100)], kv_dtype="int8")
    assert q8.kv_bytes == 2 * 100 * kvd * L + 2 * 2 * 7 * \
        cfg.num_kv_heads * 4 * L                            # 7 pages
    win = step_cost(dataclasses.replace(cfg, sliding_window=10),
                    [Row([99], 100)])
    assert win.attn_flops == 10 / 100 * one.attn_flops
    moe = get_config("deepseek-moe-16b")
    all_e = step_cost(moe, [Row([9], 10)], experts=[64] * moe.num_layers)
    routed = step_cost(moe, [Row([9], 10)])                 # 6 of 64
    per_expert = 3 * moe.d_model * moe.d_ff * 2 * moe.num_layers
    assert all_e.weight_bytes - routed.weight_bytes == 58 * per_expert
    ssm = get_config("mamba2-130m")
    fresh = step_cost(ssm, [Row(np.arange(64), 64)])
    step = step_cost(ssm, [Row([64], 65)])
    assert step.state_bytes == 2 * fresh.state_bytes > 0
    train = step_cost(cfg, [Row(np.arange(64), 64)], kind="train")
    fwd = step_cost(cfg, [Row(np.arange(64), 64)])
    assert train.weight_flops == 3 * fwd.weight_flops
    assert train.kv_bytes == 0
    assert one.least_s == max(one.t_compute, one.t_memory)
    assert one.bound_by == "bytes"
    assert step_cost(cfg, [Row(np.arange(2048), 2048)]).bound_by == \
        "operations"


@pytest.mark.parametrize("policy", ["full_recompute", "mpic"])
@pytest.mark.parametrize("pool", [None, "int8"])
def test_a_chunked_prefill_costs_what_one_pass_costs(policy, pool):
    """A request's prefill given as its chunks (rows of one ``seq``) has
    the least work of the same prefill in one pass: the weights, the KV
    and the tokens count once however many passes read them."""
    cfg = get_config("qwen2.5-14b")
    n = 1300
    q = np.arange(n) if policy == "full_recompute" else np.concatenate(
        [np.arange(40), np.arange(616, 656), np.arange(1232, n)])
    one = step_cost(cfg, [Row(q, n)], kv_dtype=pool)
    for chunk in (64, 100):
        parts = [Row(q[a:a + chunk], n, seq="r") for a in
                 range(0, len(q), chunk)]
        chunked = step_cost(cfg, parts, kv_dtype=pool)
        assert dataclasses.asdict(chunked) == dataclasses.asdict(one)
        assert chunked.least_s == one.least_s
        # passes counted apart read the weights once each and the earlier
        # chunks' KV again
        apart = [step_cost(cfg, [r], kv_dtype=pool) for r in parts]
        assert sum(c.weight_bytes for c in apart) == \
            len(parts) * one.weight_bytes
        assert sum(c.kv_bytes for c in apart) > one.kv_bytes


def test_a_pass_without_logits_skips_the_head_and_merges_by_seq():
    """A row without logits costs no head; a request's two passes (one
    without logits) read the head once and its KV once."""
    cfg = get_config("llava-1.6-7b")
    up = step_cost(cfg, [Row(np.arange(576), 576, logits=False)])
    full = step_cost(cfg, [Row(np.arange(576), 576)])
    head = cfg.d_model * cfg.vocab_size
    assert full.weight_flops - up.weight_flops == 2.0 * 576 * head
    assert full.weight_bytes - up.weight_bytes == head * 2
    assert up.io_bytes == full.io_bytes - 576 * cfg.vocab_size * 4
    both = step_cost(cfg, [Row(np.arange(576), 576, logits=False, seq=0),
                           Row(np.arange(576, 600), 600, seq=0)])
    whole = step_cost(cfg, [Row(np.arange(576), 576, logits=False, seq=0),
                            Row(np.arange(576, 600), 600, seq=1)])
    assert both.weight_bytes == full.weight_bytes
    assert both.kv_bytes == 2 * 600 * cfg.kv_dim * 2 * cfg.num_layers
    assert whole.kv_bytes - both.kv_bytes == \
        2 * 576 * cfg.kv_dim * 2 * cfg.num_layers          # 576 read again


def test_every_least_time_reads_one_peak_per_dtype():
    """``StepCost``, ``Roofline`` and ``kernel_bound`` take the same
    terms: 16-bit products at the tensor cores' peak, anything else at
    fp32's."""
    assert rl.peak_flops("float16") == rl.peak_flops(torch.bfloat16) == \
        port_mesh.H100_PEAK_FLOPS_BF16
    assert rl.peak_flops(torch.float32) == port_mesh.H100_PEAK_FLOPS_FP32
    for dtype in ("bfloat16", "float16", "float32"):
        cost = rl.StepCost(weight_flops=4e12, weight_bytes=1e9, dtype=dtype)
        roof = cost.roofline("a", "s", "m", "decode")
        ms, by = rl.kernel_bound(cost.bytes, cost.flops, dtype)
        t = rl.terms(cost.flops, cost.bytes, 0.0, dtype)
        assert cost.least_s == rl.least_time(roof) == ms / 1e3 == \
            max(t.values())
        assert cost.bound_by == by == rl.BOUND_BY[roof.bottleneck]
