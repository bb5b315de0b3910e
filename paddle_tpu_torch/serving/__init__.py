"""Serving layer of the port (the counterpart of ``paddle_tpu/serving``).

- ``InferenceServer`` (``server.py``): dynamic-batching serving over one
  ``inference.Predictor``: ``submit(feed) -> Future``, ``submit_many``,
  ``serve_forever``, ``warmup``, ``ready``/``mark_ready``, graceful
  ``shutdown(drain=True)``; a three-stage pipeline (staging, dispatch on a
  CUDA stream, completion), ``FLAGS_serving_pipeline_depth`` batches in
  flight.
- ``DynamicBatcher`` (``batcher.py``): bounded queue with backpressure
  (``QueueFullError``), deadlines (``DeadlineExceededError``),
  max_batch_size/max_wait_ms coalescing by shape signature.
- ``ShapeBucketPolicy`` / ``BucketSpec`` (``bucketing.py``): power-of-two
  batch and sequence-length buckets with zero padding and unpad-on-fetch.
- ``ServingMetrics`` (``metrics.py``): the reference's snapshot schema.
- ``generation`` (subpackage): autoregressive decode serving
  (``GenerationServer``) over a paged KV cache.
- ``scheduling`` (subpackage): multi-tenant admission control (token
  buckets, weighted-fair queuing, priority classes, ``/schedz``) and the
  fleet autoscaler.
- ``fleet`` (subpackage): multi-replica serving — replica workers, their
  supervisor, the router with the rolling weight swap, the wire codec and
  the resilience layer.

Knobs: ``FLAGS_serving_*``, ``FLAGS_sched_*``, ``FLAGS_fleet_*`` and
``FLAGS_autoscale_*`` in ``framework/flags.py``.
- ``ServingMesh`` / ``serving_mesh_from_flags`` (``mesh.py``): one replica
  over the slots of an ``{"mp": N}`` mesh (tensor-parallel decode).

``wrap_capi`` waits for ROADMAP queue 1 item 5d.
"""
from . import metrics  # noqa: F401  (the registry sub-namespace)
from .batcher import DynamicBatcher
from .bucketing import BucketSpec, ShapeBucketPolicy, next_pow2
from .metrics import ServingMetrics
from .request import (DeadlineExceededError, QueueFullError,
                      QuotaExceededError, Request, ServerClosedError)
from .server import InferenceServer
from .mesh import ServingMesh, serving_mesh_from_flags
from . import fleet, generation, scheduling  # noqa: F401,E402

__all__ = ["ServingMesh", "serving_mesh_from_flags", "InferenceServer", "DynamicBatcher", "ShapeBucketPolicy",
           "BucketSpec", "ServingMetrics", "Request", "QueueFullError",
           "QuotaExceededError", "DeadlineExceededError",
           "ServerClosedError", "next_pow2", "metrics", "generation",
           "scheduling", "fleet"]
