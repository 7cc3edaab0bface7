"""Checkpoint and resume — the port of ``paddle_tpu/train/checkpoint.py``,
with its on-disk format unchanged, so that a checkpoint crosses
frameworks: a directory the JAX ``Trainer.save`` wrote restores in the
port's :class:`~paddle_tpu_torch.train.Trainer`, and one the port wrote
restores in the JAX ``Trainer.restore``.

The format: per pass a directory ``pass-NNNNN/`` holding one ``.npz`` per
collection of the training tree (``params``, ``state``, ``opt_state``,
``step``, ``iter``), keyed by :func:`_flatten`'s ``a/b/c`` paths (a tuple
or list carries its length under ``__len_T__``/``__len_L__``, a bare
leaf is ``__value__``), and ``manifest.json`` with the pass id and a
CRC32 per file. Writes are crash-atomic (:func:`atomic_dir`: a ``.tmp``
directory swapped in, the old one renamed aside to ``.old`` first).
Leaves may be numpy arrays or torch tensors; a tensor is copied to host
memory (``to("cpu", copy=True)``) before anything is written.

One process writes; there is no multi-process rule yet (the port has no
multi-GPU training).
"""

from __future__ import annotations

import atexit
import contextlib
import json
import logging
import os
import shutil
import time
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "load_latest_valid",
           "latest_pass", "pass_dir", "atomic_dir", "write_manifest",
           "verify_manifest", "quarantine_pass_dir", "host_copy",
           "CorruptCheckpointError", "AsyncCheckpointer"]

_log = logging.getLogger("paddle_tpu_torch.checkpoint")

_MANIFEST = "manifest.json"


class CorruptCheckpointError(IOError):
    """A pass dir whose manifest/CRC integrity check failed (missing
    file, CRC mismatch, colliding entries). An ``IOError`` subclass so
    pre-fallback callers that caught ``IOError`` still do; the fallback
    chain (:func:`load_latest_valid`) and the resilience supervisor
    catch it specifically to quarantine-and-fall-back instead of dying."""


@contextlib.contextmanager
def atomic_dir(path: str):
    """Write into ``path + '.tmp'``; swap into place when the block
    succeeds. CRASH-ATOMIC: the live ``path`` is renamed aside to
    ``path + '.old'`` before the new dir renames in, so every window of a
    crash leaves at least one COMPLETE dir — ``path`` itself, or (between
    the two renames) both the finished ``.tmp`` and the previous ``.old``,
    which readers resolve via ``_resolve_pass_dir``. The prior
    ``rmtree(path); rename(tmp)`` recipe had a window with neither (the
    Go pserver writes aside then renames over, go/pserver/service.go:346)."""
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        # A manifest-complete .tmp with NO live dir is the only surviving
        # copy of this pass (crash between the two renames; readers are
        # resolving it right now) — demote it to .old instead of deleting,
        # keeping the at-least-one-complete-copy invariant through the
        # rewrite. Anything else is half-written garbage.
        if (not os.path.exists(path)
                and os.path.exists(os.path.join(tmp, _MANIFEST))):
            old = path + ".old"
            if os.path.exists(old):
                shutil.rmtree(old)
            os.rename(tmp, old)
        else:
            shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    yield tmp
    old = path + ".old"
    if os.path.exists(old):
        shutil.rmtree(old)
    if os.path.exists(path):
        os.rename(path, old)
    os.rename(tmp, path)
    if os.path.exists(old):
        shutil.rmtree(old)


def _is_pass_dir(name: str) -> bool:
    return (name.startswith("pass-")
            and not name.endswith((".tmp", ".old")))


def _base_pass_id(name: str) -> Optional[int]:
    """Pass id of a live dir OR a ``.tmp``/``.old`` crash leftover."""
    base = name[:-4] if name.endswith((".tmp", ".old")) else name
    if not base.startswith("pass-"):
        return None
    try:
        return int(base.split("-")[1])
    except (IndexError, ValueError):
        return None


def _resolve_pass_dir(root: str, pass_id: int) -> str:
    """Directory to READ pass ``pass_id`` from: the live dir, else a
    manifest-complete ``.tmp`` (newer) or ``.old`` left by a crash between
    ``atomic_dir``'s two renames. Resolution is a PURE READ — no renames —
    so concurrent readers on every host always agree and can never race an
    in-flight writer; the writer path alone mutates the root (it rebuilds
    or garbage-collects leftovers on its next save)."""
    base = pass_dir(root, pass_id)
    for d in (base, base + ".tmp", base + ".old"):
        if os.path.exists(os.path.join(d, _MANIFEST)):
            return d
    return base        # fails downstream with the usual missing-file error


def _file_crc(path: str) -> int:
    with open(path, "rb") as f:
        return zlib.crc32(f.read())


def write_manifest(d: str, meta: Optional[Dict[str, Any]] = None) -> None:
    """CRC every file in ``d`` into ``manifest.json`` (plus ``meta``)."""
    files = {f: {"crc32": _file_crc(os.path.join(d, f))}
             for f in sorted(os.listdir(d)) if f != _MANIFEST}
    with open(os.path.join(d, _MANIFEST), "w") as f:
        json.dump({**(meta or {}), "files": files}, f, indent=2)


def verify_manifest(d: str, verify_crc: bool = True) -> Dict[str, Any]:
    """Load ``manifest.json``; raise on CRC mismatch (the Go pserver's
    integrity check, ``go/pserver/service.go:346``)."""
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)
    # Early manifests keyed entries by collection name ('params') rather than
    # filename ('params.npz'); normalise so both generations load.
    normalized: Dict[str, Any] = {}
    for f, info in manifest["files"].items():
        if os.path.exists(os.path.join(d, f)):
            resolved = f
        elif os.path.exists(os.path.join(d, f + ".npz")):
            resolved = f + ".npz"
        else:
            raise CorruptCheckpointError(
                f"checkpoint {d} is missing file for manifest entry {f!r} "
                f"(neither {f!r} nor {f + '.npz'!r} exists)")
        if resolved in normalized:
            raise CorruptCheckpointError(
                f"checkpoint {d}: manifest entries collide on {resolved!r} "
                f"after legacy-name normalisation")
        normalized[resolved] = info
    manifest["files"] = normalized
    if verify_crc:
        for fname, info in manifest["files"].items():
            if _file_crc(os.path.join(d, fname)) != info["crc32"]:
                raise CorruptCheckpointError(
                    f"crc mismatch in {os.path.join(d, fname)}")
    return manifest


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        tag = "T" if isinstance(tree, tuple) else "L"
        out[f"{prefix}__len_{tag}__"] = np.asarray(len(tree))
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif tree is None:
        out[f"{prefix}__none__"] = np.asarray(0)
    else:
        # Root-level leaves (e.g. the bare `step` scalar) need a non-empty key.
        out[prefix.rstrip("/") or "__value__"] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]):
    # Rebuild nested dict/list/tuple structure from path keys.
    if list(flat.keys()) == ["__none__"]:
        return None
    if list(flat.keys()) == ["__value__"]:
        return flat["__value__"]
    if not flat:
        return {}
    # sequence marker?
    for tag, ctor in (("T", tuple), ("L", list)):
        key = f"__len_{tag}__"
        if key in flat:
            n = int(flat[key])
            items = []
            for i in range(n):
                sub = {k[len(f"{i}/"):]: v for k, v in flat.items()
                       if k.startswith(f"{i}/")}
                if not sub and str(i) in flat:
                    items.append(flat[str(i)])  # bare array element
                else:
                    items.append(_unflatten(sub))
            return ctor(items)
    out: Dict[str, Any] = {}
    leaves = {}
    children: Dict[str, Dict[str, np.ndarray]] = {}
    for k, v in flat.items():
        if "/" in k:
            head, rest = k.split("/", 1)
            children.setdefault(head, {})[rest] = v
        else:
            leaves[k] = v
    for k, v in leaves.items():
        out[k] = v
    for k, sub in children.items():
        out[k] = _unflatten(sub)
    return out


def pass_dir(root: str, pass_id: int) -> str:
    return os.path.join(root, f"pass-{pass_id:05d}")


def _leaf_to_host(x):
    if isinstance(x, torch.Tensor):
        # a copy even on the CPU: the optimizer updates its tensors in
        # place, and a view would change under a later step
        return x.detach().to("cpu", copy=True).numpy()
    return np.asarray(x)


def host_copy(tree):
    """``tree`` (dicts, lists, tuples, None) with every torch tensor
    copied to a host numpy array and every other leaf through
    ``np.asarray``."""
    if isinstance(tree, dict):
        return {k: host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        parts = [host_copy(v) for v in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") \
            else type(tree)(parts)
    if tree is None:
        return None
    return _leaf_to_host(tree)


def _snapshot_host(tree: Dict[str, Any]) -> Dict[str, Any]:
    """Every collection on the host (the only part of a save that must
    see a consistent training state)."""
    return {coll: host_copy(sub) for coll, sub in tree.items()}


def _write_pass_dir(root: str, pass_id: int, tree: Dict[str, Any],
                    keep_last: Optional[int] = None, faults=None) -> str:
    """The disk half of a save (CRC + npz write + swap + gc). Copies
    each collection to host right before writing it, so the sync path holds
    at most ONE collection in host memory at a time; the async path passes
    numpy it copied already.

    ``faults``: optional :class:`~paddle_tpu_torch.train.faults.FaultSchedule` —
    the checkpoint writer's two injection points (``fail_save_at`` before
    any byte is written; ``slow_save``/``corrupt_checkpoint_file`` after
    the atomic swap). None (the default) checks nothing."""
    fault_idx = faults.on_write_begin(pass_id) if faults is not None else None
    final = pass_dir(root, pass_id)
    with atomic_dir(final) as tmp:
        for coll, sub in tree.items():
            host = host_copy(sub)
            np.savez(os.path.join(tmp, f"{coll}.npz"), **_flatten(host))
        write_manifest(tmp, {"pass_id": pass_id})
    if faults is not None:
        faults.on_write_complete(final, pass_id, fault_idx)
    if keep_last:
        _gc(root, keep_last)
    return final


def save_checkpoint(root: str, pass_id: int, tree: Dict[str, Any],
                    keep_last: Optional[int] = None, faults=None) -> str:
    """Atomically write ``tree`` (a dict of collections) to pass-NNNNN/."""
    return _write_pass_dir(root, pass_id, tree, keep_last, faults=faults)


def _dir_bytes(d: str) -> int:
    try:
        return sum(os.path.getsize(os.path.join(d, f))
                   for f in os.listdir(d)
                   if os.path.isfile(os.path.join(d, f)))
    except OSError:
        return 0


class AsyncCheckpointer:
    """Checkpointing off the training loop's path. ``save()`` copies every
    tensor of the tree to host memory before it returns (the optimizer
    updates parameters in place, so the copy is what makes the saved
    state the state at the call), then hands the CRC, ``.npz`` writes and
    atomic swap to one background thread. The next ``save()``, ``wait()``
    or ``close()`` fences the write in flight; a background failure
    re-raises there.

    Args:
      telemetry: optional :class:`~paddle_tpu_torch.obs.Telemetry`: each
        landed save also goes to its sinks as a ``kind="checkpoint"``
        record (from the worker thread; sinks are thread-safe), and a
        failed write bumps ``telemetry.background_failures`` (in its
        ``summary()``) before re-raising at the fence.
      faults: optional :class:`~paddle_tpu_torch.train.faults.FaultSchedule`,
        threaded into the background ``_write_pass_dir`` so the save-path
        faults fire in the worker and surface at the next fence.

    ``records`` gets one dict per landed save: ``pass_id``, the host copy's
    ``snapshot_ms`` (on the caller's thread), the background ``write_ms``,
    the directory's ``bytes`` and the ``backlog_ms`` the save waited on the
    previous write; ``background_failures`` counts failed writes.

    Construction registers an ``atexit`` ``wait()`` (``close()``
    unregisters it), so an interpreter exit that skipped ``close()`` still
    fences the write in flight and logs its error."""

    def __init__(self, telemetry=None, faults=None):
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="ckpt")
        self._pending = None
        self.telemetry = telemetry
        self.faults = faults
        self.records: List[Dict[str, Any]] = []
        self.background_failures = 0
        atexit.register(self._atexit_wait)

    def _atexit_wait(self) -> None:
        """Interpreter-exit safety net: fence the in-flight write; log
        (never raise) its failure — there is no caller left to catch."""
        try:
            self.wait()
        except Exception:
            _log.exception("async checkpoint write failed at interpreter "
                           "exit (the checkpoint did not land)")

    def wait(self) -> None:
        """Block until the in-flight write (if any) lands; re-raise its
        error."""
        if self._pending is not None:
            fut, self._pending = self._pending, None
            fut.result()

    def _write_job(self, root: str, pass_id: int, host: Dict[str, Any],
                   keep_last: Optional[int], snapshot_s: float,
                   backlog_s: float) -> str:
        """The background half: the write and its record; a failure
        counts, then re-raises into the future (surfacing at the caller's
        next fence)."""
        t0 = time.perf_counter()
        try:
            final = _write_pass_dir(root, pass_id, host, keep_last,
                                    faults=self.faults)
        except BaseException:
            self.background_failures += 1
            if self.telemetry is not None:
                self.telemetry.background_failures += 1
            raise
        rec = {"pass_id": pass_id,
               "snapshot_ms": round(snapshot_s * 1e3, 3),
               "write_ms": round((time.perf_counter() - t0) * 1e3, 3),
               "bytes": _dir_bytes(final),
               "backlog_ms": round(backlog_s * 1e3, 3)}
        self.records.append(rec)
        if self.telemetry is not None:
            self.telemetry.emit_event({"kind": "checkpoint", **rec,
                                       "async": True})
        return final

    def save(self, root: str, pass_id: int, tree: Dict[str, Any],
             keep_last: Optional[int] = None) -> str:
        t0 = time.perf_counter()
        self.wait()                        # fence the previous save
        backlog_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        host = _snapshot_host(tree)
        snapshot_s = time.perf_counter() - t1
        self._pending = self._pool.submit(
            self._write_job, root, pass_id, host, keep_last, snapshot_s,
            backlog_s)
        return pass_dir(root, pass_id)

    def close(self) -> None:
        try:
            self.wait()
        finally:
            try:
                atexit.unregister(self._atexit_wait)
            except Exception:       # pragma: no cover - interpreter teardown
                pass
            self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _gc(root: str, keep_last: int):
    """Retention: keep the newest ``keep_last`` READABLE passes — live dirs
    and manifest-complete crash leftovers count equally (a crashed latest
    save may be the only copy of its pass and must survive) — then delete
    every pass-* entry (live, ``.tmp`` or ``.old``) whose pass id fell out
    of that set, so a stale leftover can never outlive and later shadow a
    pass the retention policy deleted. Entries with unparsable ids are
    left alone."""
    readable = set()
    for d in os.listdir(root):
        pid = _base_pass_id(d)
        if pid is not None and \
                os.path.exists(os.path.join(root, d, _MANIFEST)):
            readable.add(pid)
    keep = set(sorted(readable)[-keep_last:])
    for d in os.listdir(root):
        pid = _base_pass_id(d)
        if pid is not None and pid not in keep:
            shutil.rmtree(os.path.join(root, d))


def latest_pass(root: str) -> Optional[int]:
    if not os.path.isdir(root):
        return None
    ids = [pid for d in os.listdir(root)
           if (pid := _base_pass_id(d)) is not None
           and os.path.exists(os.path.join(root, d, _MANIFEST))]
    return max(ids) if ids else None


def load_checkpoint(root: str, pass_id: Optional[int] = None,
                    verify_crc: bool = True) -> Dict[str, Any]:
    """Load a checkpoint dict; raises on CRC mismatch (the Go pserver's
    integrity check, ``go/pserver/service.go:346``)."""
    if pass_id is None:
        pass_id = latest_pass(root)
        if pass_id is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    d = _resolve_pass_dir(root, pass_id)
    manifest = verify_manifest(d, verify_crc=verify_crc)
    out = {}
    for fname in manifest["files"]:
        if not fname.endswith(".npz"):
            continue
        with np.load(os.path.join(d, fname), allow_pickle=False) as z:
            out[fname[:-len(".npz")]] = _unflatten({k: z[k] for k in z.files})
    out["pass_id"] = manifest["pass_id"]
    return out


# -- fallback chain ---------------------------------------------------------

def quarantine_pass_dir(d: str) -> str:
    """Move a bad checkpoint dir aside to ``d + '.corrupt'`` — NEVER
    delete it (the bytes are forensic evidence, and deletion would turn a
    bad checksum into an unexplainable gap). The ``.corrupt`` name parses
    to no pass id, so quarantined dirs are invisible to
    :func:`latest_pass`, :func:`_resolve_pass_dir`, and retention
    (``_gc`` leaves unparsable names alone). Returns the quarantine
    path."""
    target, k = d + ".corrupt", 1
    while os.path.exists(target):
        k += 1
        target = f"{d}.corrupt{k}"
    os.rename(d, target)
    _log.warning(
        "quarantined corrupt checkpoint dir %s -> %s; falling back to the "
        "previous readable pass (inspect or delete the quarantined copy "
        "manually)", d, target)
    return target


# what a poisoned pass dir can raise at load: integrity failures
# (CorruptCheckpointError is an OSError), truncated/garbled npz (BadZipFile,
# ValueError), a garbled manifest (json errors are ValueError), or a
# manifest missing its keys (KeyError)
_LOAD_ERRORS = (OSError, ValueError, KeyError, zipfile.BadZipFile)


def load_latest_valid(root: str, verify_crc: bool = True) -> Dict[str, Any]:
    """Load the NEWEST READABLE checkpoint, quarantining every poisoned
    pass dir met on the way (the recovery half of the Go pserver's CRC
    story: it *wrote* checksums; this is what a reader does when one
    fails). Each failing dir is renamed aside via
    :func:`quarantine_pass_dir` — never silently deleted — and the chain
    falls back to the previous readable pass. Raises
    ``FileNotFoundError`` when nothing readable remains.

    The returned dict is ``load_checkpoint``'s, plus ``_quarantined``:
    the list of quarantine paths created (empty on the clean path) —
    ``Trainer.restore`` pops it into ``trainer.last_quarantined`` so the
    supervisor can count fallbacks.

    Multi-reader safe: on a shared checkpoint root, another host may
    quarantine (or retention may delete) the dir between our
    ``latest_pass`` probe and the load — a VANISHED dir is re-scanned,
    not treated as corruption, so every host racing the same poison
    converges on the same fallback pass instead of one of them dying
    (or restarting from scratch) on the other's rename."""
    quarantined: List[str] = []
    # every iteration either quarantines a dir, or re-scans after one
    # vanished — both strictly shrink the candidate set, but bound the
    # loop anyway so a pathological writer can't spin us forever
    for _ in range(10000):
        pid = latest_pass(root)
        if pid is None:
            err = FileNotFoundError(
                f"no readable checkpoints under {root}"
                + (f" ({len(quarantined)} quarantined: {quarantined})"
                   if quarantined else ""))
            err.quarantined = quarantined     # the ledger survives the raise
            raise err
        d = _resolve_pass_dir(root, pid)
        try:
            out = load_checkpoint(root, pid, verify_crc=verify_crc)
            out["_quarantined"] = quarantined
            return out
        except _LOAD_ERRORS as e:
            if not os.path.isdir(d):
                # a concurrent actor moved it (another host's quarantine,
                # retention gc) — the next probe sees the new state
                _log.warning(
                    "checkpoint pass %d vanished mid-read (%s: %s) — "
                    "re-scanning %s", pid, type(e).__name__, e, root)
                continue
            _log.warning("checkpoint pass %d failed to load (%s: %s)",
                         pid, type(e).__name__, e)
            quarantined.append(quarantine_pass_dir(d))
    raise RuntimeError(
        f"load_latest_valid({root!r}) did not converge after 10000 "
        f"attempts — a writer is racing the reader pathologically")
