"""The port's trainer against the JAX package's, on fp32 smoke configs with
the JAX weights carried over: ``train_batches``, the loss and every
gradient leaf of the dense yi-9b, the MoE granite (aux loss, capacity
drops), llava (media spans) and whisper (audio frames), one AdamW update,
``cosine_warmup``, five train steps, checkpoint files byte for byte both
ways and the launcher's lines (the SSM and the hybrid train in
``test_torch_ssm_training.py``).

Tolerances, relative ones as a leaf's error norm over its norm: loss and
each gradient leaf within 1e-4 relative (fp32 sums in another order);
AdamW moments within 1e-6 relative (the global norm sums in another
order, so the clip's scale may differ in its last bits), bf16 parameters
within one bf16 ulp; five train steps' losses within 1e-3; batches,
schedules and checkpoint bytes exact.
"""
import dataclasses
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.data import train_batches as jax_train_batches
from repro.launch import train as jax_launch_train
from repro.models import build_model as jax_build_model
from repro.training import AdamW as JaxAdamW
from repro.training import apply_updates as jax_apply_updates
from repro.training import cosine_warmup as jax_cosine_warmup
from repro.training import load_checkpoint as jax_load_checkpoint
from repro.training import make_train_step as jax_make_train_step
from repro.training import save_checkpoint as jax_save_checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.data import train_batches, with_audio
from repro_torch.launch import train as launch_train
from repro_torch.training import (
    AdamW,
    apply_updates,
    cosine_warmup,
    load_checkpoint,
    make_train_step,
    save_checkpoint,
    value_and_grad,
)
from repro_torch.weights import params_from_numpy, reference_tree

from _torch_parity import build_pair, jax_compile_cache  # noqa: F401

SEQ = 16


def _batch(cfg, n=2, seq=SEQ, seed=0, **kw):
    """One seeded batch (numpy) of the port's stream, with audio frames
    for an encoder-decoder."""
    data = train_batches(batch=n, seq=seq, vocab=cfg.vocab_size,
                         d_model=cfg.d_model, seed=seed, **kw)
    if cfg.is_encoder_decoder:
        data = with_audio(data, encoder_seq=cfg.encoder_seq,
                          d_model=cfg.d_model, seed=seed)
    return next(data)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_train_batches_match_the_reference():
    ours = train_batches(batch=3, seq=24, vocab=512, d_model=64, seed=7,
                         media_fraction=0.6)
    ref = jax_train_batches(batch=3, seq=24, vocab=512, d_model=64, seed=7,
                            media_fraction=0.6)
    for _ in range(3):
        a, b = next(ours), next(ref)
        assert list(a) == list(b)
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("arch, kw, n, seq", [
    ("yi-9b", {}, 2, SEQ),
    # 96 routed rows pass 64: capacity drops pairs
    ("granite-moe-1b-a400m", {}, 2, 48),
    ("llava-1.6-7b", {"media_fraction": 1.0}, 2, SEQ),
    ("whisper-small", {}, 2, SEQ),
])
def test_loss_and_every_gradient_match(arch, kw, n, seq):
    jm, jp, tm, tp = build_pair(arch=arch)
    batch = _batch(tm.cfg, n, seq, **kw)
    if arch == "llava-1.6-7b":
        assert batch["media_mask"].any(axis=1).all()
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = value_and_grad(tm, tp, {k: torch.as_tensor(v)
                                          for k, v in batch.items()})
    assert _rel(loss, jloss) <= 1e-4
    tree = reference_tree(grads)
    jleaves = jax.tree_util.tree_leaves_with_path(jgrads)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(jgrads)
    for (path, jg), g in zip(jleaves, jax.tree_util.tree_leaves(tree)):
        assert _rel(g.numpy(), jg) <= 1e-4, (jax.tree_util.keystr(path),
                                             _rel(g.numpy(), jg))
    if arch == "granite-moe-1b-a400m":
        assert float(torch.linalg.norm(grads["layers.0.moe.router"])) > 0


def test_one_adamw_update_matches():
    """Two updates (bias correction past step 1), a clipping global norm,
    bf16 matrices (decayed) beside fp32 vectors (not)."""
    rng = np.random.default_rng(3)
    shapes = {"a": (8, 16), "b": (16,), "c": (4, 8, 8)}
    dtypes = {"a": np.float32, "b": np.float32, "c": np.float32}
    params = {k: rng.standard_normal(s).astype(dtypes[k])
              for k, s in shapes.items()}
    jparams = {k: jnp.asarray(v, jnp.bfloat16 if v.ndim >= 2 else
                              jnp.float32) for k, v in params.items()}
    # copies: an in-place update must not write into the JAX buffers
    tparams = {k: torch.tensor(np.array(jparams[k], np.float32)).to(
        torch.bfloat16 if v.ndim >= 2 else torch.float32)
        for k, v in params.items()}
    sched = (jax_cosine_warmup(1e-2, 1, 10), cosine_warmup(1e-2, 1, 10))
    jopt, topt = JaxAdamW(lr=sched[0]), AdamW(lr=sched[1])
    jstate, tstate = jopt.init(jparams), topt.init(tparams)

    @jax.jit
    def jax_step(grads, state, params):
        updates, state = jopt.update(grads, state, params)
        return jax_apply_updates(params, updates), state

    for step in range(2):
        grads = {k: (rng.standard_normal(s) * 3).astype(np.float32)
                 for k, s in shapes.items()}
        jparams, jstate = jax_step({k: jnp.asarray(v) for k, v in
                                    grads.items()}, jstate, jparams)
        tup, tstate = topt.update({k: torch.from_numpy(v) for k, v in
                                   grads.items()}, tstate, tparams)
        apply_updates(tparams, tup)
    assert tstate.step == int(jstate.step) == 2
    for k in shapes:
        for ours, ref in ((tstate.mu[k], jstate.mu[k]),
                          (tstate.nu[k], jstate.nu[k])):
            assert ours.dtype == torch.float32
            assert _rel(ours.numpy(), ref) <= 1e-6, k
        ours = tparams[k].float().numpy()
        ref = np.asarray(jparams[k], np.float32)
        assert tparams[k].dtype == (torch.bfloat16 if ref.ndim >= 2
                                    else torch.float32)
        _, e = np.frexp(np.maximum(np.abs(ours), np.abs(ref)))
        ulp = np.ldexp(1.0, e - (8 if ref.ndim >= 2 else 24))
        assert np.all(np.abs(ours - ref) <= ulp), k


def test_cosine_warmup_matches_step_by_step():
    """Equal through the warmup; within one fp32 ulp on the cosine, where
    XLA's fp32 cosine and the correctly rounded one part in the last bit
    at some steps."""
    for peak, warmup, total, floor in ((3e-4, 20, 100, 0.1),
                                       (1e-2, 1, 7, 0.0)):
        ours = cosine_warmup(peak, warmup, total, floor)
        ref = jax_cosine_warmup(peak, warmup, total, floor)
        for step in range(total + 3):
            want = np.float32(ref(jnp.int32(step)))
            if step < warmup:
                assert ours(step) == float(want), step
            assert abs(ours(step) - float(want)) <= np.spacing(want), step


def test_five_train_steps_match():
    jm, jp, tm, tp = build_pair(arch="yi-9b")
    cfg = tm.cfg
    jdata = jax_train_batches(batch=2, seq=SEQ, vocab=cfg.vocab_size,
                              d_model=cfg.d_model)
    tdata = train_batches(batch=2, seq=SEQ, vocab=cfg.vocab_size,
                          d_model=cfg.d_model)
    jopt = JaxAdamW(lr=jax_cosine_warmup(1e-3, 2, 5))
    topt = AdamW(lr=cosine_warmup(1e-3, 2, 5))
    jstep = jax.jit(jax_make_train_step(jm, jopt))
    tstep = make_train_step(tm, topt)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    losses = []
    for _ in range(5):
        jb = {k: jnp.asarray(v) for k, v in next(jdata).items()}
        tb = {k: torch.as_tensor(v) for k, v in next(tdata).items()}
        jp, jstate, jl = jstep(jp, jstate, jb)
        tp, tstate, tl = tstep(tp, tstate, tb)
        losses.append((float(tl), float(jl)))
    for ours, ref in losses:
        assert abs(ours - ref) <= 1e-3, losses
    assert losses[-1][0] < losses[0][0]


def test_checkpoint_files_are_byte_equal_both_ways(tmp_path):
    jm, jp, _, tp = build_pair(arch="whisper-small", num_layers=1,
                               encoder_layers=1)
    extra = np.arange(6, dtype=np.float32).reshape(2, 3)
    jtree = {"params": jax.tree_util.tree_map(np.asarray, jp), "step": 300,
             "seq": [1, -40, 2.5, None, True, "x" * 40, (jnp.asarray(
                 extra, jnp.bfloat16), np.int32(7) * np.ones(2, np.int32))]}
    ttree = {"params": reference_tree(tp), "step": 300,
             "seq": [1, -40, 2.5, None, True, "x" * 40, (torch.from_numpy(
                 extra).bfloat16(), torch.full((2,), 7, dtype=torch.int32))]}
    jpath, tpath = tmp_path / "jax.msgpack", tmp_path / "torch.msgpack"
    jax_save_checkpoint(str(jpath), jtree)
    save_checkpoint(str(tpath), ttree)
    assert tpath.read_bytes() == jpath.read_bytes()
    ours, ref = load_checkpoint(str(jpath)), jax_load_checkpoint(str(tpath))
    assert jax.tree_util.tree_structure(ours) == \
        jax.tree_util.tree_structure(ref)
    for a, b in zip(jax.tree_util.tree_leaves(ours),
                    jax.tree_util.tree_leaves(ref)):
        if isinstance(a, torch.Tensor):
            assert str(a.dtype)[6:] == str(b.dtype)
            np.testing.assert_array_equal(a.float().numpy(),
                                          np.asarray(b, np.float32))
        else:
            assert a == b
    assert isinstance(ours["seq"][-1], tuple)
    back = params_from_numpy(ours["params"], dataclasses.replace(
        get_smoke_config("whisper-small"), num_layers=1, encoder_layers=1,
        param_dtype="float32", compute_dtype="float32"), "cpu")
    for (name, a), b in zip(back.named_parameters(), tp.parameters()):
        assert torch.equal(a, b), name


def _lines(text):
    return [ln for ln in text.splitlines() if ln.strip()]


def test_launcher_prints_the_references_lines(tmp_path, capsys,
                                              monkeypatch):
    """``--device cpu`` against the JAX launcher (each with its own
    seeded weights): the same first line, loss lines at the same steps;
    the checkpoint loads into the port's model.  (That the loss falls over
    30 steps is phase 5m's gate on the card.)"""
    args = ["--arch", "yi-9b", "--steps", "4", "--batch", "2", "--seq",
            "16"]
    launch_train.main([*args, "--device", "cpu", "--ckpt",
                       str(tmp_path / "ck.msgpack")])
    ours = _lines(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["train", *args])
    jax_launch_train.main()
    ref = _lines(capsys.readouterr().out)
    assert ours[0] == ref[0]
    assert re.fullmatch(r"arch=yi-9b-smoke params=[\d.]+M devices=1",
                        ours[0])
    line = re.compile(r"step +(\d+)  loss (\d+\.\d{4})  \(\d+\.\ds\)")
    steps = [[int(line.fullmatch(x).group(1)) for x in lines[1:]]
             for lines in (ours, ref)]
    assert steps[0] == steps[1] == [1, 2, 3, 4]
    losses = [float(line.fullmatch(x).group(2)) for x in ours[1:]]
    assert np.isfinite(losses).all()
    tree = load_checkpoint(str(tmp_path / "ck.msgpack"))
    assert tree["step"] == 4
    params_from_numpy(tree["params"], get_smoke_config("yi-9b"), "cpu")


def test_whisper_trains_from_the_launcher_where_the_reference_cannot(
        capsys):
    """A reference defect: the JAX launcher feeds whisper
    ``train_batches``, which carry no audio frames, and its loss fails on
    the missing ``audio_embeds``; the port's launcher adds seeded frames
    (``data.with_audio``)."""
    cfg = jax_get_smoke_config("whisper-small")
    jm = jax_build_model(cfg)
    batch = next(jax_train_batches(batch=2, seq=16, vocab=cfg.vocab_size,
                                   d_model=cfg.d_model))
    with pytest.raises(AttributeError):
        jm.loss(jm.init(jax.random.PRNGKey(0)),
                {k: jnp.asarray(v) for k, v in batch.items()})
    launch_train.main(["--arch", "whisper-small", "--steps", "2",
                       "--batch", "2", "--seq", "16", "--device", "cpu"])
    out = _lines(capsys.readouterr().out)
    assert out[0].startswith("arch=whisper-small-smoke") and len(out) == 3
