"""Replica supervisor (the port of ``paddle_tpu/serving/fleet/supervisor.py``):
spawn, watch, respawn, and scale the fleet.

``ReplicaSupervisor`` owns N replica "processes" produced by a factory.
``ProcessReplicaFactory`` spawns real worker processes (``python -m
paddle_tpu_torch.serving.fleet.worker``, this package's worker) that
announce their ephemeral port through an atomically-written file;
``worker.ThreadReplicaFactory`` swaps in in-process replicas for tests and
single-process deployments — the supervisor logic is identical.

The monitor thread polls each replica: an exit while the fleet is running
is a crash — the replica is respawned after a backoff that doubles per
consecutive crash (``FLAGS_fleet_restart_backoff_ms``), and
``paddle_fleet_replica_restarts_total`` counts it. A respawned replica runs
its warmup lattice before it reports ready. ``scale_to(n)`` grows the fleet
the same way (the router picks new replicas up from ``endpoints()``) or
retires the highest-numbered replicas gracefully.
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional

from .worker import read_announce_file

__all__ = ["ReplicaSupervisor", "ProcessReplicaFactory",
           "SubprocessReplica", "WORKER_MODULE"]

# the worker a ProcessReplicaFactory spawns: this package's, never the
# reference's
WORKER_MODULE = f"{__package__}.worker"


def _flag(name, default):
    from ...framework.flags import flag_value
    try:
        v = flag_value(name)
    except KeyError:
        return default
    return v


class SubprocessReplica:
    """ReplicaProcess protocol over a worker subprocess + its
    announce file."""

    def __init__(self, proc: subprocess.Popen, announce_path: str):
        self.proc = proc
        self.announce_path = announce_path
        self.pid = proc.pid
        self._url: Optional[str] = None

    def url(self) -> Optional[str]:
        if self._url is None:
            info = read_announce_file(self.announce_path)
            if info and info.get("pid") == self.pid:
                self._url = info["url"]
        return self._url

    def poll(self) -> Optional[int]:
        return self.proc.poll()

    def terminate(self):
        if self.proc.poll() is None:
            self.proc.terminate()

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()

    def wait(self, timeout: Optional[float] = None) -> Optional[int]:
        try:
            return self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            return None


class ProcessReplicaFactory:
    """Builds worker subprocesses. ``extra_args`` go to the worker
    CLI verbatim (e.g. ``["--stub", "--stub-device-ms", "8"]`` or
    ``["--model-prefix", "/models/m_v3"]``; ``["--cpu"]`` serves on the
    CPU); ``env`` overlays the parent environment. The spawner's live
    ``FLAGS_compile_cache_dir`` (and ``FLAGS_compile_cache_max_bytes``)
    go to every worker unless ``env`` names them, so each replica warms
    from the shared compile cache and warmup manifests (reference
    ``supervisor.py:86``)."""

    def __init__(self, *, extra_args: Optional[List[str]] = None,
                 env: Optional[Dict[str, str]] = None,
                 host: str = "127.0.0.1",
                 python: Optional[str] = None,
                 announce_dir: Optional[str] = None,
                 stdout=None, stderr=None):
        self.extra_args = list(extra_args or [])
        self.env = dict(env or {})
        self.host = host
        self.python = python or sys.executable
        self.announce_dir = announce_dir or tempfile.mkdtemp(
            prefix="paddle-fleet-")
        self.stdout = stdout
        self.stderr = stderr
        self._spawn_seq = 0

    def __call__(self, replica_id: int) -> SubprocessReplica:
        self._spawn_seq += 1
        announce = os.path.join(
            self.announce_dir,
            f"replica-{replica_id}.{self._spawn_seq}.json")
        cmd = [self.python, "-m", WORKER_MODULE,
               "--host", self.host, "--port", "0",
               "--announce", announce,
               "--name", f"replica-{replica_id}"] + self.extra_args
        env = dict(os.environ)
        from ...framework.flags import flag_value
        cache_dir = str(flag_value("FLAGS_compile_cache_dir") or "")
        if cache_dir:
            env["FLAGS_compile_cache_dir"] = cache_dir
            env["FLAGS_compile_cache_max_bytes"] = str(
                int(flag_value("FLAGS_compile_cache_max_bytes")))
        env.update(self.env)
        proc = subprocess.Popen(
            cmd, env=env,
            stdout=self.stdout if self.stdout is not None
            else subprocess.DEVNULL,
            stderr=self.stderr if self.stderr is not None
            else subprocess.DEVNULL)
        return SubprocessReplica(proc, announce)


class _PendingProc:
    """Placeholder proc for a slot whose factory call is in flight.

    Spawning (``subprocess.Popen``, model warmup) happens OUTSIDE the
    supervisor lock — a slow factory must never block ``endpoints()``
    or the monitor — so the slot is published first with this
    sentinel: alive (``poll() is None``, so the monitor never
    "respawns" it) but unannounced (``url() is None``, so the router
    never routes to it). The real proc replaces it under the lock
    once the spawn returns."""

    def poll(self):
        return None

    def url(self):
        return None

    def terminate(self):
        pass

    def kill(self):
        pass

    def wait(self, timeout=None):
        return 0


class _Managed:
    """Supervisor-side record of one replica slot."""

    __slots__ = ("replica_id", "proc", "restarts", "respawn_at",
                 "retiring")

    def __init__(self, replica_id: int, proc):
        self.replica_id = replica_id
        self.proc = proc
        self.restarts = 0
        self.respawn_at: Optional[float] = None
        self.retiring = False


class ReplicaSupervisor:
    """Spawns and keeps alive ``n_replicas`` replicas built by
    ``factory(replica_id)``. ``endpoints()`` is the router's
    discovery surface: the currently-announced ``{id: url}`` map
    (a crashed or not-yet-announced replica is absent)."""

    def __init__(self, factory: Callable[[int], object],
                 n_replicas: Optional[int] = None, *,
                 auto_restart: bool = True,
                 restart_backoff_ms: Optional[float] = None,
                 poll_interval_s: float = 0.05,
                 metrics=None, name: str = "fleet"):
        self.factory = factory
        self.n_replicas = int(
            n_replicas if n_replicas is not None
            else _flag("FLAGS_fleet_replicas", 2))
        self.auto_restart = bool(auto_restart)
        self.restart_backoff_ms = float(
            restart_backoff_ms if restart_backoff_ms is not None
            else _flag("FLAGS_fleet_restart_backoff_ms", 200.0))
        self.poll_interval_s = float(poll_interval_s)
        self.name = name
        self._metrics = metrics
        self._lock = threading.Lock()
        self._managed: Dict[int, _Managed] = {}
        self._next_id = 0
        self._stopping = False
        self._monitor: Optional[threading.Thread] = None

    # ------------------------------------------------------ lifecycle
    def _spawn_into(self, rid: int):
        """Run the factory for an already-reserved slot — called with
        the lock NOT held — then publish the proc under the lock. If
        the slot was retired or the supervisor stopped while the
        spawn was in flight, the fresh proc is terminated instead."""
        try:
            proc = self.factory(rid)
        except Exception:
            with self._lock:
                self._managed.pop(rid, None)
            raise
        with self._lock:
            m = self._managed.get(rid)
            orphaned = self._stopping or m is None or m.retiring
            if not orphaned:
                m.proc = proc
        if orphaned:
            proc.terminate()

    def start(self) -> "ReplicaSupervisor":
        with self._lock:
            if self._stopping:
                raise RuntimeError("supervisor already stopped")
            new_ids = []
            while self._next_id < self.n_replicas:
                rid = self._next_id
                self._next_id += 1
                self._managed[rid] = _Managed(rid, _PendingProc())
                new_ids.append(rid)
            if self._monitor is None or not self._monitor.is_alive():
                self._monitor = threading.Thread(
                    target=self._monitor_loop,
                    name=f"fleet-supervisor-{self.name}", daemon=True)
                self._monitor.start()
        for rid in new_ids:
            self._spawn_into(rid)
        return self

    def stop(self, timeout: float = 10.0):
        with self._lock:
            self._stopping = True
            managed = list(self._managed.values())
        for m in managed:
            m.proc.terminate()
        deadline = time.monotonic() + timeout
        for m in managed:
            left = max(0.0, deadline - time.monotonic())
            if m.proc.wait(left) is None:
                m.proc.kill()
        t = self._monitor
        if t is not None and t.is_alive() and \
                t is not threading.current_thread():
            t.join(timeout)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # ------------------------------------------------------ scaling
    def scale_to(self, n: int):
        """Grow (spawn warm replicas) or shrink (retire the
        highest-numbered ones gracefully) to ``n``."""
        n = int(n)
        to_stop = []
        new_ids = []
        with self._lock:
            self.n_replicas = n
            live = sorted(rid for rid, m in self._managed.items()
                          if not m.retiring)
            for rid in live[n:]:
                m = self._managed[rid]
                m.retiring = True
                to_stop.append(m)
            count = len(live[:n])
            while count < n:
                rid = self._next_id
                self._next_id += 1
                self._managed[rid] = _Managed(rid, _PendingProc())
                new_ids.append(rid)
                count += 1
        for m in to_stop:
            m.proc.terminate()
        for rid in new_ids:
            self._spawn_into(rid)

    # ------------------------------------------------------ discovery
    def endpoints(self) -> Dict[int, str]:
        with self._lock:
            managed = list(self._managed.values())
        out = {}
        for m in managed:
            if m.retiring or m.proc.poll() is not None:
                continue
            url = m.proc.url()
            if url:
                out[m.replica_id] = url
        return out

    def restart_counts(self) -> Dict[int, int]:
        with self._lock:
            return {rid: m.restarts
                    for rid, m in self._managed.items()}

    @property
    def replica_ids(self) -> List[int]:
        with self._lock:
            return sorted(rid for rid, m in self._managed.items()
                          if not m.retiring)

    # ------------------------------------------------------ monitor
    def _monitor_loop(self):
        while True:
            with self._lock:
                if self._stopping:
                    return
                managed = list(self._managed.items())
            now = time.monotonic()
            for rid, m in managed:
                rc = m.proc.poll()
                if rc is None:
                    continue
                if m.retiring:
                    with self._lock:
                        self._managed.pop(rid, None)
                    continue
                if not self.auto_restart:
                    continue
                if m.respawn_at is None:
                    # crash observed: schedule the respawn after a
                    # backoff that doubles per consecutive crash
                    backoff = self.restart_backoff_ms * min(
                        30.0, 2.0 ** min(m.restarts, 5))
                    with self._lock:
                        m.respawn_at = now + backoff / 1e3
                    continue
                if now < m.respawn_at:
                    continue
                try:
                    proc = self.factory(rid)
                except Exception:  # noqa: BLE001 - a failed spawn
                    # retries next tick with the same backoff ladder
                    with self._lock:
                        m.respawn_at = now + \
                            self.restart_backoff_ms / 1e3
                    continue
                with self._lock:
                    if self._stopping:
                        proc.terminate()
                        return
                    m.proc = proc
                    m.restarts += 1
                    m.respawn_at = None
                if self._metrics is not None:
                    self._metrics.count_restart()
            time.sleep(self.poll_interval_s)
