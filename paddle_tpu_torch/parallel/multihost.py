"""Host heartbeats — the port of the heartbeat half of
``paddle_tpu/parallel/multihost.py``.

Each host keeps a small JSON file fresh under a root every host mounts
(``<root>/heartbeats/host-NNNNN.json``, written atomically: tmp file and
rename), so a watchdog tells a live host from a dead one by the file's
age (:func:`detect_dead_hosts`). The files are plain host I/O, the same
bytes as the JAX package's, so either framework's watchdog reads the
other's beats. Training runs on one process until multi-GPU training is
ported, so ``host_id`` defaults to 0.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Sequence

__all__ = ["HEARTBEAT_DIRNAME", "heartbeat_path", "write_heartbeat",
           "retire_heartbeat", "read_heartbeats", "detect_dead_hosts",
           "HostHeartbeat"]

_log = logging.getLogger("paddle_tpu_torch.multihost")


HEARTBEAT_DIRNAME = "heartbeats"


def heartbeat_path(root: str, host_id: int) -> str:
    return os.path.join(root, HEARTBEAT_DIRNAME, f"host-{host_id:05d}.json")


def write_heartbeat(root: str, host_id: Optional[int] = None,
                    seq: int = 0, now: Optional[float] = None,
                    extra: Optional[Dict] = None) -> str:
    """Write one heartbeat file atomically (tmp + rename, the checkpoint
    writer's recipe — a reader never sees a torn beat). The payload
    carries provenance a watchdog can act on: host id, PID, wall-clock
    ``ts``, and a monotonically increasing ``seq`` (distinguishes a live
    host whose clock skews from a dead host whose file merely exists).
    ``extra`` merges additional JSON-safe payload fields (reserved keys
    win) — the serving fleet rides its per-replica load report on the
    beat, so a cross-process router could balance on the same evidence
    it health-checks."""
    host_id = 0 if host_id is None else int(host_id)
    path = heartbeat_path(root, host_id)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = dict(extra or {})
    payload.update({"host_id": host_id, "pid": os.getpid(),
                    "ts": time.time() if now is None else float(now),
                    "seq": int(seq)})
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)
    return path


def retire_heartbeat(root: str, host_id: int) -> Optional[str]:
    """Retire a released/dead host's heartbeat file:
    RENAME it aside (``host-NNNNN.json.retired``, a fresh numbered
    suffix when one already exists, the checkpoints' quarantine rule: never
    delete), so :func:`detect_dead_hosts` and any watchdog scanning the
    root stop re-reporting a ghost that left the fleet on purpose.
    Returns the retired path (None when there was no beat to retire).
    The bytes stay on disk for forensics; ``read_heartbeats`` skips the
    suffix by construction (it only reads ``host-*.json``)."""
    path = heartbeat_path(root, host_id)
    if not os.path.exists(path):
        return None
    dest = f"{path}.retired"
    n = 0
    while os.path.exists(dest):
        n += 1
        dest = f"{path}.retired.{n}"
    try:
        os.replace(path, dest)
    except OSError:
        _log.exception("failed to retire heartbeat %s", path)
        return None
    return dest


def read_heartbeats(root: str) -> Dict[int, Dict]:
    """All readable heartbeat payloads under ``root``, keyed by host id,
    each annotated with ``_mtime`` (the heartbeat FILE's mtime — the
    shared filesystem's clock, stamped by the storage, not by the
    writer's possibly-skewed wall clock). Torn/garbled files are skipped
    (the writer is atomic; garbage means a foreign file), missing dir
    means no beats yet."""
    d = os.path.join(root, HEARTBEAT_DIRNAME)
    if not os.path.isdir(d):
        return {}
    out: Dict[int, Dict] = {}
    for name in sorted(os.listdir(d)):
        if not (name.startswith("host-") and name.endswith(".json")):
            continue
        path = os.path.join(d, name)
        try:
            with open(path) as f:
                payload = json.load(f)
            payload["_mtime"] = os.path.getmtime(path)
            out[int(payload["host_id"])] = payload
        except (OSError, ValueError, KeyError, TypeError):
            continue
    return out


def detect_dead_hosts(root: str, timeout_s: float,
                      expected_hosts: Optional[Sequence[int]] = None,
                      now: Optional[float] = None) -> List[int]:
    """Hosts whose heartbeat is stale (older than ``timeout_s``) or
    missing entirely. ``expected_hosts`` defaults to every host that has
    EVER beaten under ``root`` (a host that never joined can't be
    declared dead from silence alone); pass the known topology — e.g.
    ``range(host_count())`` — to also catch never-joined hosts.

    Clock provenance: in production (``now=None``) staleness is the
    heartbeat FILE's mtime vs this reader's clock — ONE clock pair per
    reader, uniform across every host's file, so a beating host with a
    skewed wall clock can never be declared dead (its payload ``ts``
    would be skewed; the storage-stamped mtime is not). With an explicit
    ``now`` (deterministic tests, offline log analysis) the payload
    ``ts`` is compared instead."""
    beats = read_heartbeats(root)
    use_payload_ts = now is not None
    now = time.time() if now is None else float(now)

    def age(b):
        return now - float(b["ts"] if use_payload_ts else b["_mtime"])

    expected = (sorted(beats) if expected_hosts is None
                else sorted(int(h) for h in expected_hosts))
    return [h for h in expected
            if h not in beats or age(beats[h]) > timeout_s]


class HostHeartbeat:
    """Keep this host's heartbeat file fresh on a daemon thread (the etcd
    lease analog: liveness = a recent write to storage every peer can
    read). ``start()`` beats immediately then every ``interval_s``;
    ``stop()`` joins the thread. The resilience supervisor starts one per
    supervised run (``run_resilient(heartbeat_interval_s=...)``); a
    standalone watchdog probes the files with :func:`detect_dead_hosts`."""

    def __init__(self, root: str, interval_s: float = 10.0,
                 host_id: Optional[int] = None):
        self.root = root
        self.interval_s = float(interval_s)
        self.host_id = 0 if host_id is None else int(host_id)
        self.seq = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def beat(self) -> str:
        self.seq += 1
        return write_heartbeat(self.root, self.host_id, seq=self.seq)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.beat()
            except OSError:
                # a missed beat must never kill training — the watchdog
                # treats staleness as the signal, and one blip is below
                # any sane timeout
                _log.exception("heartbeat write failed (host %d)",
                               self.host_id)
            self._stop.wait(self.interval_s)

    def start(self) -> "HostHeartbeat":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name=f"paddle_tpu_torch.multihost.heartbeat-{self.host_id}")
            self._thread.start()
        return self

    def stop(self, join_timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=join_timeout)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
