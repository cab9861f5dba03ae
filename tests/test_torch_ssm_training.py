"""Training the pure SSM (mamba2-130m) and the hybrid (hymba-1.5b): the
port's trainer against the JAX package's, on fp32 smoke configs with the
JAX weights carried over.

The differentiable SSD core ``ssd_chunked_train`` against the JAX
package's jnp ``ssd_chunked`` and the port's serving ``ssd_chunked``;
the loss and every gradient leaf against ``jax.value_and_grad`` at one
and two SSD chunks (hymba also at two windows, where attention takes the
S x 2w band); five AdamW steps; the launcher's lines; hymba's checkpoint
bytes both ways; a sequence that is not a multiple of the chunk raising in
both packages; and the training pass calling no kernel dispatcher.

Tolerances, relative ones as a leaf's error norm over its norm: the SSD
core within 1e-5 (fp32 sums in another order), loss and each gradient
leaf within 1e-4, five train steps' losses within 1e-3.
"""
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import train_batches as jax_train_batches
from repro.launch import train as jax_launch_train
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro.training import AdamW as JaxAdamW
from repro.training import cosine_warmup as jax_cosine_warmup
from repro.training import load_checkpoint as jax_load_checkpoint
from repro.training import make_train_step as jax_make_train_step
from repro.training import save_checkpoint as jax_save_checkpoint
from repro_torch.data import train_batches
from repro_torch.launch import train as launch_train
from repro_torch.models import layers, ssm
from repro_torch.models import transformer as tf
from repro_torch.training import (
    AdamW,
    cosine_warmup,
    load_checkpoint,
    make_train_step,
    save_checkpoint,
    value_and_grad,
)
from repro_torch.weights import reference_tree

from _torch_parity import build_pair, jax_compile_cache  # noqa: F401

ARCHS = ("mamba2-130m", "hymba-1.5b")
CHUNK = 16              # the smoke configs' ssm_chunk
WINDOW = 64             # hymba's smoke window


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _ssd_inputs(seed, b=2, nc=3, q=8, h=3, hd=4, ds=5, dt_scale=1.0):
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((b, nc, q, h, hd)).astype(f)
    bm = rng.standard_normal((b, nc, q, ds)).astype(f)
    cm = rng.standard_normal((b, nc, q, ds)).astype(f)
    dtv = (rng.uniform(0.01, 0.5, (b, nc, q, h)) * dt_scale).astype(f)
    log_a = (-rng.uniform(0.5, 2.0, (h,)) * dtv).astype(f)
    h0 = rng.standard_normal((b, h, ds, hd)).astype(f)
    return x, bm, cm, log_a, dtv, h0


def test_ssd_chunked_train_matches_both_references():
    args = _ssd_inputs(0)
    want_y, want_h = jax_ssd_chunked(*map(jnp.asarray, args))
    targs = [torch.from_numpy(a) for a in args]
    y, h = ssm.ssd_chunked_train(*targs)
    sy, sh = ssm.ssd_chunked(*targs)        # the serving core, plain version
    for ours, ref in ((y, want_y), (h, want_h), (y, sy), (h, sh)):
        assert _rel(ours.numpy(), np.asarray(ref)) <= 1e-5


def test_ssd_chunked_train_stays_finite_where_the_reference_overflows():
    """At a large dt a masked pair's exponent overflows: the reference's
    mask multiplies inf by 0 (NaN); the port selects before the exponent,
    and its values and gradients stay finite and equal the serving core's
    (which composes the same terms without the masked ones)."""
    args = _ssd_inputs(1, dt_scale=400.0)
    ref_y, _ = jax_ssd_chunked(*map(jnp.asarray, args))
    assert not np.isfinite(np.asarray(ref_y)).all()
    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y, h = ssm.ssd_chunked_train(*targs)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    grads = torch.autograd.grad((y.sum() + h.sum()), targs)
    assert all(torch.isfinite(g).all() for g in grads)
    sy, _ = ssm.ssd_chunked(*[a.detach() for a in targs])
    assert _rel(y.detach().numpy(), sy.numpy()) <= 1e-5


def test_banded_attend_train_equals_windowed_attend():
    rng = np.random.default_rng(2)
    b, s, hq, hkv, dh, w = 2, 32, 4, 2, 8, 8
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (b, s, h, dh)).astype(np.float32)) for h in (hq, hkv, hkv))
    pos = torch.arange(s, dtype=torch.int32).repeat(b, 1)
    got = layers.banded_attend_train(q, k, v, pos, w)
    want = layers.attend(q, k, v, pos, pos, window=w)
    assert _rel(got.numpy(), want.numpy()) <= 1e-6


def _batch(cfg, seq, n=2, seed=0):
    data = train_batches(batch=n, seq=seq, vocab=cfg.vocab_size,
                         d_model=cfg.d_model, seed=seed)
    return next(data)


CASES = [("mamba2-130m", CHUNK), ("mamba2-130m", 2 * CHUNK),
         ("hymba-1.5b", CHUNK), ("hymba-1.5b", 2 * CHUNK),
         ("hymba-1.5b", 2 * WINDOW)]


@pytest.mark.parametrize("arch, seq", CASES,
                         ids=[f"{a.split('-')[0]}-s{s}" for a, s in CASES])
def test_loss_and_every_gradient_match(arch, seq, monkeypatch):
    jm, jp, tm, tp = build_pair(arch=arch)
    batch = _batch(tm.cfg, seq)
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    band_calls = []
    band = layers.banded_attend_train
    monkeypatch.setattr(tf, "banded_attend_train",
                        lambda *a: band_calls.append(1) or band(*a))
    loss, grads = value_and_grad(tm, tp, {k: torch.as_tensor(v)
                                          for k, v in batch.items()})
    assert len(band_calls) == (tm.cfg.num_layers if seq == 2 * WINDOW
                               else 0)
    assert _rel(loss, jloss) <= 1e-4
    tree = reference_tree(grads)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(jgrads)
    for (path, jg), g in zip(jax.tree_util.tree_leaves_with_path(jgrads),
                             jax.tree_util.tree_leaves(tree)):
        assert _rel(g.numpy(), jg) <= 1e-4, (jax.tree_util.keystr(path),
                                             _rel(g.numpy(), jg))
    assert float(torch.linalg.norm(grads["layers.0.ssm.A_log"])) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_training_calls_no_kernel_dispatcher(arch, monkeypatch):
    """The training pass reaches neither the SSD chunk (kernel 6) nor the
    dense selective attention (kernel 5), nor their plain versions."""
    _, _, tm, tp = build_pair(arch=arch)

    def refuse(*a, **k):
        raise AssertionError("a kernel dispatcher ran in training")

    for mod, name in ((ssm, "ssd_chunk"), (tf, "selective_attention"),
                      (layers, "selective_attention")):
        monkeypatch.setattr(mod, name, refuse)
    seq = 2 * WINDOW if arch == "hymba-1.5b" else 2 * CHUNK
    loss, _ = value_and_grad(tm, tp, {k: torch.as_tensor(v) for k, v in
                                      _batch(tm.cfg, seq).items()})
    assert np.isfinite(float(loss))


@pytest.mark.parametrize("arch", ARCHS)
def test_non_multiple_sequence_raises_in_both_packages(arch):
    jm, jp, tm, tp = build_pair(arch=arch)
    batch = _batch(tm.cfg, CHUNK + 3)
    with pytest.raises(AssertionError, match="ssm_chunk"):
        jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    with pytest.raises(ValueError, match="ssm_chunk"):
        value_and_grad(tm, tp, {k: torch.as_tensor(v)
                                for k, v in batch.items()})
    assert all(not p.requires_grad for p in tp.parameters())


@pytest.mark.parametrize("arch", ARCHS)
def test_five_train_steps_match(arch):
    jm, jp, tm, tp = build_pair(arch=arch)
    cfg = tm.cfg
    jdata = jax_train_batches(batch=2, seq=2 * CHUNK, vocab=cfg.vocab_size,
                              d_model=cfg.d_model)
    tdata = train_batches(batch=2, seq=2 * CHUNK, vocab=cfg.vocab_size,
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


def _lines(text):
    return [ln for ln in text.splitlines() if ln.strip()]


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_prints_the_references_lines(arch, tmp_path, capsys,
                                              monkeypatch):
    """``--device cpu`` against the JAX launcher (each with its own seeded
    weights): the same first line and loss lines at the same steps; the
    checkpoint loads back."""
    args = ["--arch", arch, "--steps", "3", "--batch", "2", "--seq",
            str(2 * CHUNK)]
    launch_train.main([*args, "--device", "cpu", "--ckpt",
                       str(tmp_path / "ck.msgpack")])
    ours = _lines(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["train", *args])
    jax_launch_train.main()
    ref = _lines(capsys.readouterr().out)
    assert ours[0] == ref[0]
    assert re.fullmatch(rf"arch={arch}-smoke params=[\d.]+M devices=1",
                        ours[0])
    line = re.compile(r"step +(\d+)  loss (\d+\.\d{4})  \(\d+\.\ds\)")
    steps = [[int(line.fullmatch(x).group(1)) for x in lines[1:]]
             for lines in (ours, ref)]
    assert steps[0] == steps[1] == [1, 2, 3]
    assert np.isfinite([float(line.fullmatch(x).group(2))
                        for x in ours[1:]]).all()
    assert load_checkpoint(str(tmp_path / "ck.msgpack"))["step"] == 3


def test_hybrid_checkpoint_bytes_equal_both_ways(tmp_path):
    jm, jp, _, tp = build_pair(arch="hymba-1.5b")
    jpath, tpath = tmp_path / "jax.msgpack", tmp_path / "torch.msgpack"
    jax_save_checkpoint(str(jpath), {"params": jax.tree_util.tree_map(
        np.asarray, jp), "step": 5})
    save_checkpoint(str(tpath), {"params": reference_tree(tp), "step": 5})
    assert tpath.read_bytes() == jpath.read_bytes()
    ours, ref = load_checkpoint(str(jpath)), jax_load_checkpoint(str(tpath))
    for a, b in zip(jax.tree_util.tree_leaves(ours),
                    jax.tree_util.tree_leaves(ref)):
        if isinstance(a, torch.Tensor):
            np.testing.assert_array_equal(a.float().numpy(),
                                          np.asarray(b, np.float32))
        else:
            assert a == b
