"""paddle_tpu_torch.elastic: preemption-tolerant training, the port of
``paddle_tpu/elastic``.

Elasticity is job-level restart plus a bit-identical checkpoint resume:

- :class:`CheckpointManager` captures the full training state (parameters,
  optimizer accumulators, LR-scheduler step, global step, dataloader
  epoch/offset, numpy's and the port's RNG) on a step or wall-clock
  cadence, off the critical path, onto the crash-safe checkpoint layer in
  ``framework.checkpoint`` (staged ``.tmp`` directories, per-file fsync,
  a manifest-commit rename: a ``kill -9`` at any instant leaves the
  previous or the new checkpoint whole);
- :class:`PreemptionHandler` turns SIGTERM/SIGINT into one last
  bounded-deadline save before the conventional termination;
- ``restore_latest()`` quarantines corrupt or partial directories and
  falls back, so recovery never dead-ends on save debris;
- save and restore times, bytes, the last committed step and the steps
  lost to a preemption land on the shared metric registry, with a
  checkpoint-staleness check on ``/healthz``.

The drill: ``python -m paddle_tpu_torch.tools.faultinject`` SIGKILLs a
training worker (``paddle_tpu_torch.tools.elastic_ckpt_worker``) mid-step,
mid-save and mid-commit, SIGTERMs it once, and holds the resumed loss
trajectory bit for bit against an uninterrupted run.
"""
from .manager import (CheckpointManager, RestoreResult,  # noqa: F401
                      latest_checkpoint)
from .preemption import (DEFAULT_PREEMPT_SIGNALS,  # noqa: F401
                         PreemptionHandler)
from ..framework.checkpoint import (AsyncCheckpointHandle,  # noqa: F401
                                    CheckpointCorruptError,
                                    list_checkpoints, load_sharded,
                                    prune_checkpoints, save_sharded)

__all__ = [
    "CheckpointManager", "RestoreResult", "latest_checkpoint",
    "PreemptionHandler", "DEFAULT_PREEMPT_SIGNALS",
    "AsyncCheckpointHandle", "CheckpointCorruptError",
    "list_checkpoints", "load_sharded", "prune_checkpoints",
    "save_sharded",
]
