"""The port's checkpoint module (``paddle_tpu_torch/train/checkpoint.py``)
against the JAX package's, and its crash and corruption behaviour
(CPU): the same tree written by both holds the same ``.npz`` keys,
arrays and dtypes and loads in the other; a flipped byte raises
``CorruptCheckpointError``; a manifest keyed by collection name loads;
missing and colliding entries raise; a crash at each rename of
``atomic_dir``'s swap, or in the middle of a write, leaves a loadable
pass; quarantine and the fallback chain; ``keep_last``; the
``AsyncCheckpointer``'s fence, its error at the fence, and its host copy
taken before ``save`` returns, so steps that update the tensors in place
right after do not reach the file. Arrays are compared exactly: a
checkpoint moves bytes, it computes nothing."""

import json
import os
import threading

import numpy as np
import pytest
import torch

from paddle_tpu.train import checkpoint as jckpt
from paddle_tpu_torch.train import checkpoint as ckpt
from paddle_tpu_torch.train import faults as faults_lib


def _tree(val=1.0):
    return {"params": {"m": {"w": np.full((3, 2), val, np.float32),
                             "b": np.arange(2, dtype=np.float32)}},
            "state": {},
            "opt_state": ({}, ({"m": {"w": np.ones((3, 2), np.float32)}},
                               {"m": {"w": np.zeros((3, 2), np.float32)}})),
            "step": np.asarray(7, np.int32),
            "iter": {"pass": 0, "next_batch": 4, "completed": 0,
                     "batch_crc": 123}}


def _equal_trees(a, b):
    """Same nesting (a NamedTuple loads as a tuple), same leaves and
    dtypes (a Python int is saved as int64, as ``np.asarray`` makes it)."""
    if isinstance(a, dict):
        assert isinstance(b, dict)
        assert set(a) == set(b)
        for k in a:
            _equal_trees(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, tuple if isinstance(a, tuple) else list)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_trees(x, y)
    else:
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_format_matches_jax_both_ways(tmp_path):
    tree = _tree()
    dp = ckpt.save_checkpoint(str(tmp_path / "port"), 0, tree)
    dj = jckpt.save_checkpoint(str(tmp_path / "jax"), 0, tree)
    assert sorted(os.listdir(dp)) == sorted(os.listdir(dj))
    for name in os.listdir(dp):
        if name.endswith(".npz"):
            with np.load(os.path.join(dp, name)) as zp, \
                    np.load(os.path.join(dj, name)) as zj:
                assert sorted(zp.files) == sorted(zj.files)
                for k in zp.files:
                    assert zp[k].dtype == zj[k].dtype, (name, k)
                    np.testing.assert_array_equal(zp[k], zj[k])
    with open(os.path.join(dp, "manifest.json")) as f:
        mp = json.load(f)
    with open(os.path.join(dj, "manifest.json")) as f:
        mj = json.load(f)
    assert mp["pass_id"] == mj["pass_id"] == 0
    assert sorted(mp["files"]) == sorted(mj["files"])
    # each side loads the other's directory
    for root, load in ((tmp_path / "jax", ckpt.load_checkpoint),
                       (tmp_path / "port", jckpt.load_checkpoint)):
        out = load(str(root))
        assert out["pass_id"] == 0
        for coll in tree:
            _equal_trees(out[coll], tree[coll])


def test_torch_leaves_are_copied_to_host(tmp_path):
    w = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    ckpt.save_checkpoint(str(tmp_path), 0,
                         {"params": {"w": w}, "step": np.asarray(1)})
    out = ckpt.load_checkpoint(str(tmp_path))
    np.testing.assert_array_equal(out["params"]["w"], w.numpy())
    assert int(out["step"]) == 1


def test_crc_detects_corruption(tmp_path):
    d = ckpt.save_checkpoint(str(tmp_path), 0,
                             {"params": {"w": np.ones((2, 2))},
                              "step": np.asarray(5)})
    with open(os.path.join(d, "params.npz"), "r+b") as f:
        f.seek(30)
        f.write(b"\xff\xff")
    with pytest.raises(ckpt.CorruptCheckpointError, match="crc"):
        ckpt.load_checkpoint(str(tmp_path))


def test_loads_collection_keyed_manifest(tmp_path):
    ckpt.save_checkpoint(str(tmp_path), 0, {"params": {"w": np.arange(4.)}})
    d = ckpt.pass_dir(str(tmp_path), 0)
    with open(os.path.join(d, "manifest.json")) as f:
        man = json.load(f)
    man["files"] = {k[:-len(".npz")] if k.endswith(".npz") else k: v
                    for k, v in man["files"].items()}
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump(man, f)
    out = ckpt.load_checkpoint(str(tmp_path))
    np.testing.assert_array_equal(out["params"]["w"], np.arange(4.0))


@pytest.mark.parametrize("extra,match", [({"ghost": {"crc32": 0}}, "ghost"),
                                         ({"params": {"crc32": 0}},
                                          "collide")])
def test_manifest_missing_entry_and_collision(tmp_path, extra, match):
    ckpt.save_checkpoint(str(tmp_path), 0, {"params": {"w": np.arange(4.)},
                                            "step": np.asarray(1)})
    d = ckpt.pass_dir(str(tmp_path), 0)
    with open(os.path.join(d, "manifest.json")) as f:
        man = json.load(f)
    man["files"] = {**man["files"], **extra}
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump(man, f)
    with pytest.raises(ckpt.CorruptCheckpointError, match=match):
        ckpt.verify_manifest(d)


@pytest.mark.parametrize("crash_at", [1, 2])
def test_crash_inside_swap_leaves_a_loadable_pass(tmp_path, monkeypatch,
                                                  crash_at):
    root = str(tmp_path)
    ckpt.save_checkpoint(root, 0, {"params": {"w": np.full((4,), 1.0)}})
    real = os.rename
    count = {"n": 0}

    def boom(src, dst):
        count["n"] += 1
        if count["n"] == crash_at:
            raise RuntimeError("simulated crash inside atomic swap")
        return real(src, dst)

    monkeypatch.setattr(ckpt.os, "rename", boom)
    with pytest.raises(RuntimeError, match="simulated crash"):
        ckpt.save_checkpoint(root, 0, {"params": {"w": np.full((4,), 2.0)}})
    monkeypatch.setattr(ckpt.os, "rename", real)
    assert ckpt.latest_pass(root) == 0
    w = np.asarray(ckpt.load_checkpoint(root, 0)["params"]["w"])
    assert w[0] in (1.0, 2.0), w


def test_crash_mid_write_keeps_the_only_copy(tmp_path, monkeypatch):
    root = str(tmp_path)
    ckpt._write_pass_dir(root, 0, {"params": {"w": np.full((2,), 1.0)}})
    os.rename(os.path.join(root, "pass-00000"),
              os.path.join(root, "pass-00000.tmp"))
    assert ckpt.latest_pass(root) == 0

    def boom(*a, **k):
        raise RuntimeError("simulated crash mid-write")

    monkeypatch.setattr(ckpt.np, "savez", boom)
    with pytest.raises(RuntimeError, match="mid-write"):
        ckpt.save_checkpoint(root, 0, {"params": {"w": np.full((2,), 2.0)}})
    monkeypatch.undo()
    out = ckpt.load_checkpoint(root, 0)
    np.testing.assert_array_equal(out["params"]["w"], np.full((2,), 1.0))


def test_incomplete_tmp_is_never_adopted(tmp_path):
    root = str(tmp_path)
    ckpt.save_checkpoint(root, 0, {"params": {"w": np.arange(3.0)}})
    stray = os.path.join(root, "pass-00001.tmp")
    os.makedirs(stray)
    with open(os.path.join(stray, "params.npz"), "wb") as f:
        f.write(b"garbage")
    assert ckpt.latest_pass(root) == 0
    np.testing.assert_array_equal(
        ckpt.load_checkpoint(root)["params"]["w"], np.arange(3.0))
    assert os.path.isdir(stray)


def test_keep_last_and_crash_leftovers(tmp_path):
    root = str(tmp_path)
    for i in range(4):
        ckpt.save_checkpoint(root, i, {"params": {"w": np.full((2,), i)}},
                             keep_last=10)
    os.rename(os.path.join(root, "pass-00000"),
              os.path.join(root, "pass-00000.old"))
    np.testing.assert_array_equal(
        ckpt.load_checkpoint(root, 0)["params"]["w"], np.zeros((2,)))
    ckpt._write_pass_dir(root, 5, {"params": {"w": np.full((2,), 5.0)}})
    os.rename(os.path.join(root, "pass-00005"),
              os.path.join(root, "pass-00005.tmp"))
    os.makedirs(os.path.join(root, "pass-backup"))
    ckpt._gc(root, keep_last=2)
    left = sorted(d for d in os.listdir(root) if d.startswith("pass-"))
    assert left == ["pass-00003", "pass-00005.tmp", "pass-backup"]
    assert ckpt.latest_pass(root) == 5
    for i in range(6, 9):
        ckpt.save_checkpoint(root, i, {"params": {"w": np.full((2,), i)}},
                             keep_last=2)
    assert sorted(d for d in os.listdir(root) if d.startswith("pass-0")) \
        == ["pass-00007", "pass-00008"]


def _save(root, pass_id, val):
    ckpt.save_checkpoint(str(root), pass_id,
                         {"params": {"w": np.full((4,), float(val))}})


def test_quarantine_and_fallback_chain(tmp_path):
    _save(tmp_path, 0, 1.0)
    _save(tmp_path, 1, 2.0)
    assert faults_lib.corrupt_one_file(
        os.path.join(str(tmp_path), "pass-00001")) is not None
    out = ckpt.load_latest_valid(str(tmp_path))
    assert out["pass_id"] == 0
    np.testing.assert_array_equal(out["params"]["w"], np.ones((4,)))
    q = os.path.join(str(tmp_path), "pass-00001.corrupt")
    assert out["_quarantined"] == [q] and os.path.isdir(q)
    # quarantined dirs are invisible to latest_pass and retention
    ckpt._gc(str(tmp_path), keep_last=1)
    assert os.path.isdir(q)
    # a second quarantine of the same name gets a suffix
    _save(tmp_path, 1, 3.0)
    ckpt.quarantine_pass_dir(os.path.join(str(tmp_path), "pass-00001"))
    assert os.path.isdir(q + "2")
    # nothing readable: FileNotFoundError carrying the ledger
    faults_lib.corrupt_one_file(os.path.join(str(tmp_path), "pass-00000"))
    with pytest.raises(FileNotFoundError) as ei:
        ckpt.load_latest_valid(str(tmp_path))
    assert len(ei.value.quarantined) == 1


def test_async_fences_and_matches_sync(tmp_path):
    saver = ckpt.AsyncCheckpointer()
    gate = threading.Event()
    real_write = ckpt._write_pass_dir

    def slow_write(*a, **k):
        gate.wait(timeout=10)
        return real_write(*a, **k)

    ckpt._write_pass_dir = slow_write
    try:
        saver.save(str(tmp_path / "a"), 0, _tree(2.0))
        assert ckpt.latest_pass(str(tmp_path / "a")) is None   # in flight
        gate.set()
        saver.wait()
        assert ckpt.latest_pass(str(tmp_path / "a")) == 0
    finally:
        ckpt._write_pass_dir = real_write
        saver.close()
    ckpt.save_checkpoint(str(tmp_path / "s"), 0, _tree(2.0))
    a = ckpt.load_checkpoint(str(tmp_path / "a"))
    s = ckpt.load_checkpoint(str(tmp_path / "s"))
    for coll in _tree():
        _equal_trees(a[coll], s[coll])
    rec, = saver.records
    assert rec["pass_id"] == 0 and rec["bytes"] > 0
    assert rec["snapshot_ms"] >= 0 and rec["write_ms"] >= 0


def test_async_error_surfaces_at_fence(tmp_path, monkeypatch):
    saver = ckpt.AsyncCheckpointer()

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "_write_pass_dir", boom)
    try:
        saver.save(str(tmp_path), 0, {"params": {"w": np.ones((2,))}})
        with pytest.raises(OSError, match="disk full"):
            saver.wait()
    finally:
        saver.close()
    assert saver.background_failures == 1 and not saver.records


def test_async_snapshot_is_taken_before_the_next_in_place_step(tmp_path):
    """The optimizer updates parameters in place: the saver copies every
    tensor before ``save`` returns, so steps right after it (here while
    the write is held back) do not reach the file."""
    w = torch.ones(64, 8)
    saver = ckpt.AsyncCheckpointer()
    gate = threading.Event()
    real_write = ckpt._write_pass_dir

    def slow_write(*a, **k):
        gate.wait(timeout=10)
        return real_write(*a, **k)

    ckpt._write_pass_dir = slow_write
    try:
        saver.save(str(tmp_path), 0, {"params": {"w": w},
                                      "step": np.asarray(3, np.int32)})
        for _ in range(3):                 # steps, in place
            w.add_(1.0)
        gate.set()
        saver.close()
    finally:
        ckpt._write_pass_dir = real_write
    out = ckpt.load_checkpoint(str(tmp_path))
    np.testing.assert_array_equal(out["params"]["w"], np.ones((64, 8)))
    assert float(w[0, 0]) == 4.0


def test_fault_points_in_the_writer(tmp_path):
    fs = faults_lib.FaultSchedule(fail_save_at=0, corrupt_checkpoint_file=1)
    with pytest.raises(faults_lib.InjectedSaveError):
        ckpt.save_checkpoint(str(tmp_path), 0, _tree(), faults=fs)
    assert ckpt.latest_pass(str(tmp_path)) is None      # nothing landed
    ckpt.save_checkpoint(str(tmp_path), 0, _tree(), faults=fs)
    with pytest.raises(ckpt.CorruptCheckpointError):
        ckpt.load_checkpoint(str(tmp_path), 0)
    assert fs.fired == [("fail_save_at", 0), ("corrupt_checkpoint_file", 1)]
