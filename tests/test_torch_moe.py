"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's, on its weights, in fp32 on the CPU.

Capacity dispatch decides which (token, choice) pairs drop from the number
of rows routed, so the routing itself is held exactly: the chosen experts,
each pair's position in its expert's buffer and the kept/dropped mask equal
the JAX ones at T <= 64 (capacity T, nothing drops) and at T > 64, where
the test shows that pairs do drop.  Top-k ties go to the lower expert index
as in ``jax.lax.top_k``.  Outputs: within 1e-5 of the largest output (fp32
sums in another order), the aux loss rtol 1e-5; model logits atol 1e-4.  Then the weight bridge, the model passes of the
smoke deepseek-moe-16b (one shared expert; MHA) and granite-moe-1b-a400m
(no shared expert; G 2): a dense prefill past 64 tokens, and the paged
selective prefill with pad rows (which route too) on both pools (int8:
atol 5e-3, see the test).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe

from _torch_parity import build_pair, smoke_configs
# autouse: JAX's persistent compilation cache while this module runs
from _torch_parity import jax_compile_cache  # noqa: F401

ATOL = 1e-4


def assert_close(out, ref):
    """Within 1e-5 of the largest |ref|: the expert outputs reach several
    hundred on unit-variance inputs, and fp32 sums of that size in another
    order differ by ~1e-3 (~1e-6 of them)."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
MOE_ARCHS = ("deepseek-moe-16b", "granite-moe-1b-a400m")
# deepseek's routing at small widths: 64 experts, top-6, 2 shared
DEEPSEEK_ROUTING = dict(num_experts=64, experts_per_token=6,
                        num_shared_experts=2, d_model=64, d_ff=32)


def _moe_pair(arch, seed=0, **over):
    """(config, JAX params, port MoE module with the same weights)."""
    _, cfg = smoke_configs(arch, **over)
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), cfg)
    mod = moe.MoE(cfg, torch.float32, "cpu")
    with torch.no_grad():
        for name in ("router", "w_gate", "w_up", "w_down"):
            getattr(mod, name).copy_(torch.from_numpy(np.asarray(jp[name])))
        if mod.shared is not None:
            for name in ("w_gate", "w_up", "w_down"):
                getattr(mod.shared, name).copy_(torch.from_numpy(
                    np.asarray(jp["shared"][name])))
    return cfg, jp, mod


def _jax_routing(jp, cfg, xt):
    """The reference's routing steps, as its ``moe_ffn`` runs them."""
    e, k = cfg.num_experts, cfg.experts_per_token
    t = xt.shape[0]
    probs = jax.nn.softmax(jnp.asarray(xt) @ jp["router"], axis=-1)
    _, gate_idx = jax.lax.top_k(probs, k)
    onehot = jax.nn.one_hot(gate_idx, e, dtype=jnp.int32)
    flat = onehot.reshape(t * k, e)
    pos = jnp.sum((jnp.cumsum(flat, axis=0) - flat).reshape(t, k, e)
                  * onehot, axis=-1)
    cap = t if t <= 64 else max(1, int(1.25 * k * t / e))
    return np.asarray(gate_idx), np.asarray(pos), np.asarray(pos < cap)


CASES = [(arch, t) for arch in MOE_ARCHS for t in (40, 64, 300)] + [
    ("deepseek-routing", 48), ("deepseek-routing", 500)]


@pytest.mark.parametrize("arch,t", CASES, ids=[f"{a}-T{t}" for a, t in CASES])
def test_moe_ffn_matches_jax(arch, t):
    over = DEEPSEEK_ROUTING if arch == "deepseek-routing" else {}
    cfg, jp, mod = _moe_pair(arch if not over else "deepseek-moe-16b", **over)
    rng = np.random.default_rng(t)
    # a direction every token shares, as hidden states do, skews the load
    x = (rng.standard_normal((2, t // 2, cfg.d_model))
         + rng.standard_normal(cfg.d_model)).astype(np.float32)
    jout, jaux = jmoe.moe_ffn(jp, cfg, jnp.asarray(x))
    tout, taux = moe.moe_ffn(mod, cfg, torch.from_numpy(x))
    assert_close(tout.numpy(), jout)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    # the routing itself, pair by pair
    xt = x.reshape(t, cfg.d_model)
    _, gate_idx, _, pos, keep, cap = moe.route(mod.router, cfg,
                                               torch.from_numpy(xt))
    jidx, jpos, jkeep = _jax_routing(jp, cfg, xt)
    np.testing.assert_array_equal(gate_idx.numpy(), jidx)
    np.testing.assert_array_equal(pos.numpy(), jpos)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    assert cap == moe.capacity(cfg, t)
    dropped = int((~keep).sum())
    if t <= 64:
        assert cap == t and dropped == 0
    else:
        # the drop rule bites at these sizes: the parity covers it
        assert dropped > 0, (cap, np.bincount(jidx.ravel()))


def test_capacity_rule():
    _, cfg = smoke_configs("deepseek-moe-16b", **DEEPSEEK_ROUTING)
    assert moe.capacity(cfg, 64) == 64
    assert moe.capacity(cfg, 65) == int(1.25 * 6 * 65 / 64)
    # deepseek at an image's 576 rows: 67 slots for a mean load of 54
    assert moe.capacity(cfg, 576) == 67
    assert moe.capacity(dataclasses.replace(cfg, num_experts=4000), 70) == 1


@pytest.mark.parametrize("ties", ["all", "pairs"])
def test_top_k_ties_take_the_lower_index(ties):
    """Equal router probabilities: the port picks the experts
    ``jax.lax.top_k`` picks, lower index first."""
    cfg, jp, mod = _moe_pair("deepseek-moe-16b", **DEEPSEEK_ROUTING)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((1, 20, cfg.d_model)).astype(np.float32)
    router = np.asarray(jp["router"]).copy()
    if ties == "all":
        x[0, :10] = 0.0                 # zero logits: every expert ties
    else:
        router[:, 1::2] = router[:, 0::2]   # experts 2i and 2i+1 tie
    jp = dict(jp, router=jnp.asarray(router))
    with torch.no_grad():
        mod.router.copy_(torch.from_numpy(router))
    xt = x.reshape(20, cfg.d_model)
    _, gate_idx, _, _, _, _ = moe.route(mod.router, cfg, torch.from_numpy(xt))
    jidx, _, _ = _jax_routing(jp, cfg, xt)
    np.testing.assert_array_equal(gate_idx.numpy(), jidx)
    if ties == "all":
        assert (gate_idx.numpy()[:10] == np.arange(6)).all()
    jout, _ = jmoe.moe_ffn(jp, cfg, jnp.asarray(x))
    tout, _ = moe.moe_ffn(mod, cfg, torch.from_numpy(x))
    assert_close(tout.numpy(), jout)


def test_shared_experts_at_deepseeks_routing_shape():
    """deepseek's two shared experts run on every token, dropped pairs
    included: the output less the routed part is the shared SwiGLU."""
    cfg, jp, mod = _moe_pair("deepseek-moe-16b", **DEEPSEEK_ROUTING)
    assert mod.shared.w_gate.shape == (cfg.d_model, 2 * cfg.d_ff)
    x = np.random.default_rng(4).standard_normal(
        (1, 300, cfg.d_model)).astype(np.float32)
    tx = torch.from_numpy(x)
    tout, _ = moe.moe_ffn(mod, cfg, tx)
    shared = mod.shared
    mod.shared = None
    routed, _ = moe.moe_ffn(mod, cfg, tx)
    mod.shared = shared
    sp = shared
    want = (torch.nn.functional.silu(tx @ sp.w_gate) * (tx @ sp.w_up)) \
        @ sp.w_down
    assert_close((tout - routed).numpy(), want.numpy())
    jout, _ = jmoe.moe_ffn(jp, cfg, jnp.asarray(x))
    assert_close(tout.numpy(), jout)
    # a token all of whose pairs dropped keeps the shared output alone
    _, _, _, _, keep, _ = moe.route(mod.router, cfg, tx[0])
    gone = (~keep).all(dim=1)
    if gone.any():
        assert_close(tout[0, gone].numpy(), want[0, gone].numpy())


# -- the model with MoE layers -------------------------------------------------

@pytest.fixture(scope="module", params=MOE_ARCHS)
def pair(request):
    return build_pair(arch=request.param)


def test_configs_register(pair):
    from repro.configs import get_config as jax_get
    from repro_torch.configs import get_config
    arch = pair[2].cfg.name[:-len("-smoke")]
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jax_get(arch))


def test_weight_bridge_carries_the_moe_leaves(pair):
    _, jparams, tmodel, tparams = pair
    lay = jparams["layers"]["moe"]
    for i, lp in enumerate(tparams.layers):
        assert not hasattr(lp, "mlp")
        assert lp.moe.router.dtype == torch.float32
        for name in ("router", "w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(getattr(lp.moe, name).numpy(),
                                          np.asarray(lay[name][i]))
        if tmodel.cfg.num_shared_experts:
            for name in ("w_gate", "w_up", "w_down"):
                np.testing.assert_array_equal(
                    getattr(lp.moe.shared, name).numpy(),
                    np.asarray(lay["shared"][name][i]))
        else:
            assert lp.moe.shared is None


def test_seeded_init_draws_the_moe_weights(pair):
    tmodel = pair[2]
    params = tmodel.init(seed=3, device="cpu")
    lp = params.layers[0]
    cfg = tmodel.cfg
    assert lp.moe.router.dtype == torch.float32
    assert lp.moe.w_gate.shape == (cfg.num_experts, cfg.d_model, cfg.d_ff)
    # dense_init's scale: 1/sqrt(fan_in), the stacked weights' fan-in E
    std = float(lp.moe.w_gate.float().std())
    assert abs(std * np.sqrt(cfg.num_experts) - 1.0) < 0.05
    assert abs(float(lp.moe.router.std()) * np.sqrt(cfg.d_model) - 1) < 0.1


def test_dense_prefill_matches_past_64_tokens(pair):
    """A contiguous prefill of 90 tokens: T 90 > 64, so capacity drops
    pairs in every layer, in both packages alike."""
    jmodel, jparams, tmodel, tparams = pair
    toks = np.random.default_rng(5).integers(
        8, tmodel.cfg.vocab_size, (1, 90)).astype(np.int32)
    jl, _ = jmodel.prefill(jparams, jnp.asarray(toks),
                           jmodel.make_cache(1, 96))
    tl, _ = tmodel.prefill(tparams, torch.from_numpy(toks),
                           tmodel.make_cache(1, 96, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)


@pytest.mark.parametrize("pool", ["fp32", "int8"])
def test_paged_prefill_routes_the_pad_rows(pair, pool):
    """The paged selective prefill of 70 selected tokens padded to 80 rows
    (as ``bucket`` pads them): the pad rows route with the real ones, so
    T is 80 and the capacity rule of T > 64 applies, in both packages
    alike.  On the int8 pool the requantized codes may differ by one step
    (``test_torch_model.py``), which the experts' large outputs carry to
    the logits: atol 5e-3 there (the logits reach ~1.4)."""
    jmodel, jparams, tmodel, tparams = pair
    cfg = tmodel.cfg
    ps, npg, scratch = 8, 24, 0
    rng = np.random.default_rng(6)
    n, sq, length = 70, 80, 150
    page_table = (1 + rng.permutation(npg - 1)[:19])[None].astype(np.int32)
    pos = np.zeros((1, sq), np.int32)
    pos[0, :n] = np.sort(rng.choice(length, n, replace=False))
    real = np.arange(sq)[None] < n
    wp = np.where(real, np.take_along_axis(page_table, pos // ps, 1),
                  scratch).astype(np.int32)
    wo = np.where(real, pos % ps, ps - 1).astype(np.int32)
    tokens = rng.integers(8, cfg.vocab_size, (1, sq)).astype(np.int32)
    shape = (cfg.num_layers, npg, ps, cfg.num_kv_heads, cfg.head_dim)
    if pool == "int8":
        pools = [rng.integers(-127, 128, shape).astype(np.int8)
                 for _ in range(2)] + [
            rng.uniform(0.002, 0.01, shape[:2] + shape[3:4]).astype(
                np.float32) for _ in range(2)]
    else:
        pools = [(rng.standard_normal(shape) * 0.5).astype(np.float32)
                 for _ in range(2)] + [None, None]
    rest = (page_table, np.asarray([length], np.int32), wp, wo)
    jout = jmodel.selective_prefill_paged(
        jparams, jnp.asarray(tokens), jnp.asarray(pos),
        *[jnp.asarray(a) for a in pools[:2]], *[jnp.asarray(a) for a in rest],
        *[None if a is None else jnp.asarray(a) for a in pools[2:]],
        backend="ref")
    tp = [None if a is None else torch.from_numpy(a.copy()) for a in pools]
    tl = tmodel.selective_prefill_paged(
        tparams, torch.from_numpy(tokens), torch.from_numpy(pos), *tp[:2],
        *[torch.from_numpy(a) for a in rest], *tp[2:])
    np.testing.assert_allclose(tl.numpy()[real], np.asarray(jout[0])[real],
                               atol=ATOL if pool == "fp32" else 5e-3, rtol=0)
    # with the pad rows T is 80: without them the capacity would differ
    assert moe.capacity(cfg, sq) != moe.capacity(cfg, n)
