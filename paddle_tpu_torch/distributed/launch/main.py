"""``python -m paddle_tpu_torch.distributed.launch``: the multi-process
trainer launcher, the port of ``paddle_tpu/distributed/launch/main.py``.

It keeps the reference's environment contract verbatim, one process a
rank:

  PADDLE_TRAINER_ID        rank of this process
  PADDLE_TRAINERS_NUM      world size
  PADDLE_TRAINER_ENDPOINTS comma list host:port, one per rank
  PADDLE_CURRENT_ENDPOINT  this rank's endpoint
  PADDLE_RANK_IN_NODE      local rank
  PADDLE_MASTER            host:port of the TCPStore rendezvous
  TRAINING_ROLE            TRAINER
  FLAGS_selected_gpus      the local rank (the reference's
                           FLAGS_selected_tpus)

Rank 0 hosts the TCPStore inside ``init_parallel_env``, which builds the
process group on it (NCCL, or gloo when ranks share a card). The flags
are the reference's (``--nproc_per_node``, ``--nnodes``, ``--node_rank``,
``--master``, ``--log_dir`` with one ``workerlog.<rank>`` a rank,
``--devices``, ``--elastic_level``, ``--max_restarts``, ``--np``) except
``--jax_distributed``, which has no counterpart. The exit code is the
first failing rank's; its peers are stopped (SIGTERM, then SIGKILL after
10 s). Each rank starts in a process group of its own, and the launcher
kills each rank's whole group when the job ends, so nothing a rank
started outlives it.
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time


def _free_port():
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="spawn one training process per device/worker")
    ap.add_argument("--nproc_per_node", type=int,
                    default=int(os.environ.get("PADDLE_NPROC_PER_NODE", 1)))
    ap.add_argument("--nnodes", type=int, default=1)
    ap.add_argument("--node_rank", type=int, default=0)
    ap.add_argument("--master", default=None,
                    help="host:port of the rendezvous store (rank 0 hosts)")
    ap.add_argument("--log_dir", default=None)
    ap.add_argument("--devices", default=None,
                    help="accepted for reference-CLI parity")
    ap.add_argument("--elastic_level", type=int, default=0,
                    help=">0 enables restart-on-failure (reference "
                         "elastic/manager.py; here a full-job "
                         "restart + checkpoint resume, SURVEY §5.3)")
    ap.add_argument("--max_restarts", type=int, default=3)
    ap.add_argument("--np", dest="np_range", default=None,
                    help="elastic world-size range MIN:MAX (reference "
                         "elastic --np syntax). Starts at MAX; scales IN "
                         "when a rank fails repeatedly (lost resource) "
                         "and honors operator elastic/scale_to requests "
                         "— each relaunch re-lowers onto the new mesh "
                         "via checkpoint resume (SURVEY §5.3)")
    ap.add_argument("training_script")
    ap.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return ap.parse_args(argv)


SCALE_RC = -1000  # sentinel: attempt ended by a scale request, not failure


def launch(argv=None) -> int:
    args = parse_args(argv)
    min_np = max_np = None
    if args.np_range:
        lo, _, hi = str(args.np_range).partition(":")
        min_np = int(lo)
        max_np = int(hi or lo)
        if args.elastic_level <= 0:
            args.elastic_level = 1
    max_failures = args.max_restarts if args.elastic_level > 0 else 0
    current_np = max_np or args.nproc_per_node
    rc = 1
    attempt = 0       # counts every relaunch (workers' resume signal)
    failures = 0      # only genuine failures consume restart budget
    scale_events = 0  # bounded so a misbehaving operator can't loop us
    last_failed_rank = None
    while True:
        rc, failed_rank, scale_to = _launch_once(args, attempt,
                                                 nproc=current_np)
        if rc == 0 or args.elastic_level <= 0:
            return rc
        if rc == SCALE_RC:
            # operator-requested resize: relaunch on the new mesh without
            # consuming restart budget (membership change, not failure)
            scale_events += 1
            if scale_events > 16:
                print("elastic: too many resize requests; giving up",
                      file=sys.stderr)
                return 1
            new_np = max(min_np or 1, min(scale_to, max_np or scale_to))
            if args.nnodes > 1:
                print("elastic: live resize is single-node only; "
                      "ignoring request", file=sys.stderr)
                new_np = current_np
            if new_np == current_np:
                print(f"elastic: resize request {scale_to} clamps to the "
                      f"current world {current_np}; continuing unchanged",
                      file=sys.stderr)
            else:
                print(f"elastic: scaling {current_np} -> {new_np} "
                      f"workers (operator request); re-lowering onto "
                      f"the new mesh", file=sys.stderr)
                current_np = new_np
            attempt += 1  # workers read RESTARTS>0 to resume checkpoints
            continue
        failures += 1
        if failures > max_failures:
            return rc
        if min_np is not None and failed_rank is not None \
                and failed_rank == last_failed_rank \
                and current_np - 1 >= min_np:
            # the same rank died twice in a row: treat its slot as a lost
            # resource and scale in (the reference's membership-shrink on
            # node loss, elastic/manager.py:126)
            current_np -= 1
            print(f"elastic: rank {failed_rank} failed repeatedly; "
                  f"scaling in to {current_np} workers", file=sys.stderr)
            last_failed_rank = None
        else:
            last_failed_rank = failed_rank
        attempt += 1
        print(f"elastic: job failed (rc={rc}); restart "
              f"{failures}/{max_failures}", file=sys.stderr)


class _HeartbeatWatcher:
    """Launcher half of elastic fault detection: hosts a LAUNCHER-owned
    TCPStore (so its life doesn't depend on any worker — the rank-0
    rendezvous store dies with rank 0) and reads the ``hb/<rank>`` keys
    workers bump (distributed/env.py ``_start_heartbeat``). Reports a
    rank whose beat has not advanced for ``timeout`` seconds: a
    SIGSTOPped or livelocked worker never exits, so exit-code monitoring
    alone misses it (reference: ElasticManager watchdog,
    fleet/elastic/manager.py:126). Ranks are armed only after their first
    beat — startup/compile time cannot false-trigger. Scope is per node:
    each node's launcher watches its own workers."""

    def __init__(self, ranks):
        from ...native.tcp_store import TCPStore
        self.ranks = list(ranks)
        self.timeout = float(os.environ.get(
            "PADDLE_ELASTIC_HEARTBEAT_TIMEOUT", "30"))
        self.interval = max(0.5, float(os.environ.get(
            "PADDLE_ELASTIC_HEARTBEAT_INTERVAL", "2")))
        # a pinned port lets operators/tooling connect for membership
        # queries and elastic/scale_to requests
        port = int(os.environ.get("PADDLE_ELASTIC_HB_PORT", 0) or 0) \
            or _free_port()
        self._store = TCPStore(host="127.0.0.1", port=port,
                               is_master=True, timeout=10.0)
        self.endpoint = f"127.0.0.1:{self._store.port}"
        self._last = {}       # rank -> (value, wall time it changed)
        self._next_check = 0.0

    def publish_world(self, world):
        """Membership view for operators (reference: etcd node list)."""
        try:
            self._store.set("elastic/world", str(world).encode())
        except Exception:
            pass

    def scale_request(self, current_world):
        """An operator-set elastic/scale_to value != current world, or
        None. Throttled to the heartbeat interval — an unthrottled call
        would hammer the store ~20x/sec from the 50ms monitor loop."""
        now = time.time()
        if now < getattr(self, "_next_scale_check", 0.0):
            return None
        self._next_scale_check = now + self.interval
        try:
            val = int(self._store.get("elastic/scale_to").decode())
        except Exception:
            return None
        if val and val != current_world:
            try:
                self._store.delete("elastic/scale_to")
            except Exception:
                pass
            return val
        return None

    def poll(self, live_ranks=None):
        """Return a stale rank id among ``live_ranks`` (default: all), or
        None. A rank that already exited keeps a frozen key — only ranks
        still running can be declared silent."""
        now = time.time()
        if now < self._next_check:
            return None
        self._next_check = now + self.interval
        ranks = self.ranks if live_ranks is None else \
            [r for r in self.ranks if r in live_ranks]
        for r in ranks:
            try:
                val = self._store.get(f"hb/{r}")
            except KeyError:
                continue  # rank hasn't started heartbeating yet
            except Exception:
                return None  # transient store error; retry next round
            prev = self._last.get(r)
            if prev is None or prev[0] != val:
                self._last[r] = (val, now)
            elif now - prev[1] > self.timeout:
                return r
        return None

    def close(self):
        try:
            self._store.close()
        except Exception:
            pass


def _launch_once(args, attempt: int = 0, nproc=None):
    """Run one job attempt. Returns (rc, failed_rank, scale_to):
    rc==SCALE_RC means the attempt was stopped by an operator resize
    request (scale_to holds the target world)."""
    nproc = nproc or args.nproc_per_node
    world = nproc * args.nnodes
    if args.nnodes > 1:
        # multi-node: rank 0 (node 0) hosts the store; every node must be
        # told where it is, and must advertise a reachable address
        if not args.master:
            raise SystemExit(
                "--master host:port is required when --nnodes > 1 "
                "(node 0 hosts the rendezvous store there)")
        host = os.environ.get("POD_IP") or socket.gethostbyname(
            socket.gethostname())
    else:
        host = "127.0.0.1"
    master = args.master or f"{host}:{_free_port()}"
    base_port = _free_port()
    # single-node endpoints are exact; multi-node lists this node's span
    # (the env contract only requires PADDLE_MASTER to be globally correct)
    endpoints = ",".join(f"{host}:{base_port + i}" for i in range(world))

    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)

    watcher = None
    if args.elastic_level > 0:
        try:
            watcher = _HeartbeatWatcher(
                [args.node_rank * nproc + i for i in range(nproc)])
        except Exception as e:  # heartbeat is best-effort; restarts still
            print(f"elastic: heartbeat store unavailable ({e}); "
                  f"exit-code monitoring only", file=sys.stderr)

    procs = []
    for local in range(nproc):
        rank = args.node_rank * nproc + local
        env = dict(os.environ)
        # workers resolve imports against the launch cwd (the script's own
        # directory is what python puts on sys.path otherwise)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (os.getcwd(), env.get("PYTHONPATH", "")) if p)
        env.update({
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(world),
            "PADDLE_TRAINER_ENDPOINTS": endpoints,
            "PADDLE_CURRENT_ENDPOINT":
                endpoints.split(",")[rank],
            "PADDLE_RANK_IN_NODE": str(local),
            "PADDLE_MASTER": master,
            "TRAINING_ROLE": "TRAINER",
            "FLAGS_selected_gpus": str(local),
        })
        if args.elastic_level > 0:
            # which elastic attempt this is — workers use it to decide
            # whether to resume from checkpoint (ElasticManager.restarts).
            # Only set when THIS launcher owns the restart loop, so an
            # outer orchestrator's values are never clobbered.
            env["PADDLE_ELASTIC_RESTARTS"] = str(attempt)
            env["PADDLE_ELASTIC_LEVEL"] = str(args.elastic_level)
            if watcher is not None:
                env["PADDLE_ELASTIC_HB_ENDPOINT"] = watcher.endpoint
        if args.log_dir:
            out = open(os.path.join(args.log_dir,
                                    f"workerlog.{rank}"), "w")
        else:
            out = None
        cmd = [sys.executable, "-u", args.training_script,
               *args.training_script_args]
        procs.append((rank, subprocess.Popen(
            cmd, env=env, stdout=out,
            stderr=subprocess.STDOUT if out else None,
            start_new_session=True),
            out))

    rc = 0
    failed_rank = None
    scale_to = None
    if watcher is not None:
        watcher.publish_world(world)
    try:
        live = {r: p for r, p, _ in procs}

        def _kill_all(reason, code, force=False):
            """Stop remaining ranks. Default: SIGTERM + 10s grace then
            SIGKILL (peers get to flush checkpoints/logs). ``force``
            SIGKILLs immediately — required for the heartbeat path, where
            a SIGSTOPped process ignores SIGTERM forever."""
            nonlocal rc, live
            print(reason, file=sys.stderr)
            rc = code
            for q in live.values():
                if q.poll() is None:
                    q.kill() if force else q.terminate()
            deadline = time.time() + 10
            for q in live.values():
                try:
                    q.wait(max(0.1, deadline - time.time()))
                except subprocess.TimeoutExpired:
                    q.kill()
            live = {}

        while live:
            for r, p in list(live.items()):
                code = p.poll()
                if code is None:
                    continue
                del live[r]
                if code != 0:
                    failed_rank = r
                    _kill_all(f"rank {r} exited with code {code}; "
                              f"terminating peers", code)
                    break
            if live and watcher is not None:
                stale = watcher.poll(set(live))
                if stale is not None:
                    failed_rank = stale
                    _kill_all(
                        f"elastic: rank {stale} heartbeat silent for "
                        f">{watcher.timeout:.0f}s (hung or stopped); "
                        f"restarting job", 1, force=True)
                elif args.np_range:
                    req = watcher.scale_request(world)
                    if req is not None:
                        scale_to = req
                        _kill_all(
                            f"elastic: resize to {req} requested; "
                            f"checkpoint-stop for mesh change", SCALE_RC)
            time.sleep(0.05)
    except KeyboardInterrupt:
        for r, p, _ in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGINT)
        rc = 130
    finally:
        if watcher is not None:
            watcher.close()
        for _, p, out in procs:
            _kill_group(p)
            if out is not None:
                out.close()
    return rc, failed_rank, scale_to


def _kill_group(p):
    """SIGKILL what is left of a rank's process group (the rank itself
    and anything it started)."""
    try:
        os.killpg(p.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass
    try:
        p.wait(5)
    except subprocess.TimeoutExpired:
        pass


if __name__ == "__main__":
    sys.exit(launch())
