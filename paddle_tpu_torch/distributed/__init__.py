"""The port's ``distributed`` surface: ``fleet.utils.recompute`` and, on one
device, ``DataParallel``, ``get_rank`` and ``get_world_size`` (meshes and
collectives wait for ROADMAP queue 1 item 5c)."""
from .parallel import DataParallel, get_rank, get_world_size  # noqa: F401
