"""paddle_tpu_torch.serving.fleet — multi-replica serving (the port of
``paddle_tpu/serving/fleet``).

One ``InferenceServer`` process tops out at one GIL and one device queue;
production traffic needs N of them behind one front end. This package is
that fleet:

- ``ReplicaSupervisor`` (supervisor.py) spawns and keeps alive N replica
  worker processes (``worker.py`` run as ``python -m
  paddle_tpu_torch.serving.fleet.worker``, on the card unless passed
  ``--cpu``), each hosting an ``InferenceServer`` (and optionally a
  ``GenerationServer``) that runs its warmup lattice before it reports
  ready; a crashed replica is respawned automatically, and
  ``scale_to(n)`` grows or shrinks the fleet (``scheduling.
  FleetAutoscaler`` drives it from SLO burn alerts, queue depth and
  occupancy).
- ``FleetRouter`` (router.py) load-balances ``submit`` / ``submit_many``
  / ``submit_generate`` across replicas (least-outstanding), routes only
  to READY replicas, sheds load by retrying a replica's
  ``QueueFullError`` elsewhere before failing the batch, streams decode
  tokens back per request, and performs the rolling hot weight swap
  (``swap_weights``): drain one replica, ``/reload`` the version-stamped
  artifact, verify ready, next.
- ``RouterApp`` / ``ReplicaApp`` are the stdlib-HTTP shells; ``codec.py``
  is the explicit binary wire format (no pickle on sockets).
- ``FleetMetrics`` (metrics.py) exports the ``paddle_fleet_*`` families;
  the router's ``/metrics?merged=1`` view re-labels every replica's own
  scrape with ``replica="<id>"``, and its ``/tracez`` stitches router and
  replica spans into one trace.
- Resilience (resilience.py): deadline propagation (the codec's ``PDDL``
  trailer), per-replica circuit breakers with half-open probing, retries
  with jittered exponential backoff, hedged ``submit``/``submit_many``,
  and the device-wedge watchdog (``arm_wedge_watchdog``) that turns a hung
  dispatch into a typed ``ReplicaWedgedError`` and a respawn.

``ThreadReplicaFactory`` runs replicas as threads of one process (the
single-process deployment mode): the kernels' launch counters are
lock-guarded for it. Knobs: ``FLAGS_fleet_*`` and
``FLAGS_serving_ready_requires_warmup`` in framework/flags.py.
"""
from __future__ import annotations

from . import codec  # noqa: F401
from . import resilience  # noqa: F401
from .metrics import FleetMetrics, merge_prometheus_texts
from .resilience import (CircuitBreaker, Deadline, ReplicaWedgedError,
                         WedgeMonitor, WedgeWatchdog)
from .router import (FleetRouter, NoReadyReplicaError, ReplicaError,
                     RouterApp)
from .supervisor import (ProcessReplicaFactory, ReplicaSupervisor,
                         SubprocessReplica)
from .worker import (PredictorBackend, ReplicaApp, StubBackend,
                     ThreadReplicaFactory, arm_canary,
                     arm_wedge_watchdog)

__all__ = [
    "FleetRouter", "RouterApp", "ReplicaSupervisor",
    "ProcessReplicaFactory", "SubprocessReplica", "ReplicaApp",
    "PredictorBackend", "StubBackend", "ThreadReplicaFactory",
    "FleetMetrics", "merge_prometheus_texts", "NoReadyReplicaError",
    "ReplicaError", "codec", "resilience", "CircuitBreaker",
    "Deadline", "ReplicaWedgedError", "WedgeMonitor", "WedgeWatchdog",
    "arm_wedge_watchdog", "arm_canary",
]
