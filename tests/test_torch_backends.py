"""The port's memory and disk storage backends (``repro_torch.cache.
backends``), on their own and against the JAX package's ``DiskBackend``.

A block round-trips through the disk tier bit-identically; a corrupt,
truncated or hash-mismatched file is a counted miss and is unlinked; a
read that fails with ``OSError`` is a miss that leaves the file; writes
are atomic (no ``.tmp`` file is left, a stale one is swept); and a block
either package's ``DiskBackend`` spooled is read by the other's under the
same key.  Inputs are seeded numpy arrays; every comparison is exact.
"""
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.cache import backends as jb
from repro.cache import quant as jq
from repro_torch.cache import backends as tb
from repro_torch.cache import quant as tq

SCOPE = ("u0", "img")


def _payload(kind, seed=0):
    """(port payload, JAX payload) with the same values."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 9, 2, 8)).astype(np.float32)
    y = rng.standard_normal((2, 9, 2, 8)).astype(np.float32)
    if kind == "int8":
        return (tb.KVPayload(qk=tq.quantize_kv(torch.from_numpy(x), 4),
                             qv=tq.quantize_kv(torch.from_numpy(y), 4)),
                jb.KVPayload(qk=jq.quantize_kv(x, 4), qv=jq.quantize_kv(y, 4)))
    tdt = getattr(torch, kind)
    ndt = np.float32 if kind == "float32" else ml_dtypes.bfloat16
    return (tb.KVPayload(k=torch.from_numpy(x).to(tdt),
                         v=torch.from_numpy(y).to(tdt)),
            jb.KVPayload(k=x.astype(ndt), v=y.astype(ndt)))


def _same(p: tb.KVPayload, q) -> None:
    """Equal stored arrays (dtype names, shapes, bytes) of two payloads."""
    a, b = p.stored_arrays(), q.stored_arrays()
    assert len(a) == len(b)
    for s, t in zip(a, b):
        sa = tq.host_array(s)
        tba = tq.host_array(t) if isinstance(t, torch.Tensor) else t
        assert tq.dtype_name(s) == (tq.dtype_name(t) if isinstance(
            t, torch.Tensor) else str(t.dtype))
        assert sa.shape == tba.shape
        assert sa.tobytes() == np.ascontiguousarray(tba).tobytes()


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_disk_round_trip(kind, tmp_path):
    p, _ = _payload(kind)
    disk = tb.DiskBackend(str(tmp_path))
    key = tb.content_key(p, SCOPE)
    disk.put(key, p)
    assert disk.contains(key)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    got = disk.get(key)
    _same(got, p)
    assert all(t.device.type == "cpu" for t in got.stored_arrays())
    st = disk.stats()
    assert (st["hits"], st["misses"], st["puts"]) == (1, 0, 1)
    assert st["bytes_read"] == st["bytes_written"] == p.stored_nbytes
    assert 0.0 <= st["verify_s"] <= st["fetch_s"]
    disk.delete(key)
    disk.delete(key)                        # idempotent
    assert not disk.contains(key) and disk.get(key) is None
    assert disk.stats()["deletes"] == 1


def test_disk_without_a_directory_makes_one_at_first_write():
    disk = tb.DiskBackend()
    p, _ = _payload("float32")
    key = tb.content_key(p, SCOPE)
    assert disk.spool_dir is None and disk.get(key) is None
    disk.put(key, p)
    try:
        assert os.path.isdir(disk.spool_dir)
        _same(disk.get(key), p)
    finally:
        disk.delete(key)
        os.rmdir(disk.spool_dir)


def _spooled(tmp_path):
    p, _ = _payload("float32")
    disk = tb.DiskBackend(str(tmp_path))
    key = tb.content_key(p, SCOPE)
    disk.put(key, p)
    return disk, key, disk.path_for(key)


def test_corrupt_file_is_an_unlinked_miss(tmp_path):
    disk, key, path = _spooled(tmp_path)
    with open(path, "wb") as f:
        f.write(b"not a zip file at all")
    assert disk.get(key) is None
    assert not os.path.exists(path)
    st = disk.stats()
    assert (st["corrupt"], st["misses"], st["hits"]) == (1, 1, 0)


def test_truncated_file_is_an_unlinked_miss(tmp_path):
    disk, key, path = _spooled(tmp_path)
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data[:len(data) // 2])
    assert disk.get(key) is None
    assert not os.path.exists(path)
    assert disk.stats()["corrupt"] == 1


def test_hash_mismatch_is_an_unlinked_miss(tmp_path):
    disk, key, path = _spooled(tmp_path)
    other, _ = _payload("float32", seed=5)  # a whole file, wrong content
    tq.spool_payload(path, other)
    assert disk.get(key) is None
    assert not os.path.exists(path)
    assert disk.stats()["corrupt"] == 1


def test_read_oserror_is_a_miss_that_keeps_the_file(tmp_path, monkeypatch):
    disk, key, path = _spooled(tmp_path)

    def failing(file):
        raise OSError(5, "I/O error", file)

    monkeypatch.setattr(tb, "unspool_payload", failing)
    assert disk.get(key) is None
    assert os.path.exists(path)
    st = disk.stats()
    assert (st["io_errors"], st["misses"], st["corrupt"]) == (1, 1, 0)


def test_failed_write_raises_and_leaves_no_tmp(tmp_path, monkeypatch):
    disk = tb.DiskBackend(str(tmp_path))
    p, _ = _payload("float32")

    def full(*a, **k):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(tb, "spool_payload", full)
    with pytest.raises(OSError):
        disk.put("k-1", p)
    assert os.listdir(tmp_path) == []
    assert disk.stats()["io_errors"] == 1 and disk.stats()["puts"] == 0


def test_stale_tmp_files_are_swept(tmp_path):
    (tmp_path / "abc.123.npz.tmp").write_bytes(b"half a block")
    disk = tb.DiskBackend(str(tmp_path))
    assert disk.stats()["tmp_swept"] == 1
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_jax_spooled_block_reads_in_port(kind, tmp_path):
    p, jp = _payload(kind)
    key = jb.content_key(jp, SCOPE)
    assert key == tb.content_key(p, SCOPE)
    jb.DiskBackend(str(tmp_path)).put(key, jp)
    got = tb.DiskBackend(str(tmp_path)).get(key)
    assert got is not None
    _same(got, p)


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_port_spooled_block_reads_in_jax(kind, tmp_path):
    p, jp = _payload(kind)
    key = tb.content_key(p, SCOPE)
    meta = tb.BlockMetadata(media_id="img", key=key, scope_user="u0",
                            ident=tb.scope_digest(SCOPE))
    tb.DiskBackend(str(tmp_path)).put(key, p, meta)
    jdisk = jb.DiskBackend(str(tmp_path))
    got = jdisk.get(key)
    assert got is not None and jdisk.stats()["corrupt"] == 0
    _same(p, got)
    # the JAX package's rehydration scan can index the file
    assert jdisk.read_meta(jdisk.path_for(key))["user_id"] == "u0"


def test_memory_backend():
    mem = tb.MemoryBackend(hbm_capacity=10, host_capacity=20)
    p, _ = _payload("float32")
    assert mem.get("a") is None
    mem.put("a", p)
    assert mem.get("a") is p and mem.contains("a")
    mem.delete("a")
    mem.delete("a")
    st = mem.stats()
    assert (st["hits"], st["misses"], st["puts"], st["deletes"],
            st["blocks"]) == (1, 1, 1, 1, 0)
    assert (st["hbm_capacity"], st["host_capacity"]) == (10, 20)
