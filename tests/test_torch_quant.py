"""The port's int8 KV quantization, spool wire format and block keys
against the JAX package's (``repro.cache.quant`` / ``repro.cache.backends``).

Inputs are seeded numpy arrays.  Tolerance: none.  Quantized bytes,
scales and dequantized values are bit-identical (the same fp32 amax,
division and round-half-to-even); a spool file written by either package
reads back in the other with equal dtype and bytes, for fp32, bf16 and
int8 payloads (whole-sequence and per-block scales); content keys and
scope digests are equal strings.  No test here combines ``@given`` with
``tmp_path``.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.cache import backends as jb
from repro.cache import quant as jq
from repro_torch.cache import backends as tb
from repro_torch.cache import quant as tq

SHAPE = (2, 37, 3, 8)           # (L, S, H, Dh); 37 tokens: ragged blocks


def _x(seed=0, scale=3.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(SHAPE).astype(np.float32) * scale
    x[1, :, 2] = 0.0                    # an all-zero slice: scale 1.0
    return x


def _equal(t: torch.Tensor, a: np.ndarray) -> None:
    """Same dtype name, shape and bytes."""
    assert tq.dtype_name(t) == str(a.dtype)
    assert tuple(t.shape) == a.shape
    assert tq.host_array(t).tobytes() == np.ascontiguousarray(a).tobytes()


@pytest.mark.parametrize("bt", [None, 16, 3])
def test_quantize_kv_bit_identical(bt):
    x = _x()
    ref = jq.quantize_kv(x, block_tokens=bt)
    out = tq.quantize_kv(torch.from_numpy(x), block_tokens=bt)
    assert out.block_tokens == ref.block_tokens
    _equal(out.q, ref.q)
    _equal(out.scale, ref.scale)
    assert out.nbytes == ref.nbytes
    _equal(tq.dequantize_kv(out), jq.dequantize_kv(ref))


def test_quantize_rejects_block_of_zero():
    with pytest.raises(ValueError):
        tq.quantize_kv(torch.zeros(SHAPE), block_tokens=0)


def _payloads(kind):
    """(JAX payload, port payload) holding the same values."""
    x, y = _x(1), _x(2)
    if kind in ("float32", "bfloat16"):
        dt = np.float32 if kind == "float32" else ml_dtypes.bfloat16
        k, v = x.astype(dt), y.astype(dt)
        tk = torch.from_numpy(x).to(getattr(torch, kind))
        tv = torch.from_numpy(y).to(getattr(torch, kind))
        return jb.KVPayload(k=k, v=v), tb.KVPayload(k=tk, v=tv)
    bt = {"int8": None, "int8_block": 16}[kind]
    jp = jb.KVPayload(qk=jq.quantize_kv(x, block_tokens=bt),
                      qv=jq.quantize_kv(y, block_tokens=bt))
    tp = tb.KVPayload(qk=tq.quantize_kv(torch.from_numpy(x), block_tokens=bt),
                      qv=tq.quantize_kv(torch.from_numpy(y), block_tokens=bt))
    return jp, tp


KINDS = ["float32", "bfloat16", "int8", "int8_block"]


def _check_same(tfields: dict, jfields: dict) -> None:
    assert set(tfields) == set(jfields)
    for name, tval in tfields.items():
        jval = jfields[name]
        if name in ("qk", "qv"):
            assert tval.block_tokens == jval.block_tokens
            _equal(tval.q, jval.q)
            _equal(tval.scale, jval.scale)
        else:
            _equal(tval, jval)


@pytest.mark.parametrize("kind", KINDS)
def test_port_spool_reads_in_jax(kind, tmp_path):
    jp, tp = _payloads(kind)
    path = tmp_path / "block.npz"
    tq.spool_payload(str(path), tp, meta={"media_id": "m"})
    jfields = jq.unspool_payload(str(path))
    _check_same(tq.unspool_payload(str(path)), jfields)
    # and the values are the JAX payload's own
    _check_same({n: getattr(tp, n) for n in jfields}, jfields)
    assert jq.read_spool_meta(str(path)) == {"media_id": "m"}


@pytest.mark.parametrize("kind", KINDS)
def test_jax_spool_reads_in_port(kind, tmp_path):
    jp, tp = _payloads(kind)
    path = tmp_path / "block.npz"
    jq.spool_payload(str(path), jp, meta={"media_id": "m"})
    tfields = tq.unspool_payload(str(path))
    _check_same(tfields, {n: getattr(jp, n) for n in tfields})
    assert tq.read_spool_meta(str(path)) == {"media_id": "m"}


def test_spool_without_meta(tmp_path):
    _, tp = _payloads("float32")
    path = tmp_path / "block.npz"
    tq.spool_payload(str(path), tp)
    assert tq.read_spool_meta(str(path)) is None
    assert jq.read_spool_meta(str(path)) is None


@pytest.mark.parametrize("salt", [None, "s3cret"])
@pytest.mark.parametrize("kind", KINDS)
def test_content_key_equal(kind, salt):
    jp, tp = _payloads(kind)
    scope = ("user7", "img-3")
    key = tb.content_key(tp, scope, salt)
    assert key == jb.content_key(jp, scope, salt)
    assert tb.scope_digest(scope, salt) == jb.scope_digest(scope, salt)
    assert tb.verify_payload(tp, key) and jb.verify_payload(jp, key)
    # another scope keeps the content half, another payload changes it
    other = tb.content_key(tp, ("user8", "img-3"), salt)
    assert other.split("-")[0] == key.split("-")[0] and other != key
    assert not tb.verify_payload(_payloads("float32")[1] if kind != "float32"
                                 else _payloads("bfloat16")[1], key)
