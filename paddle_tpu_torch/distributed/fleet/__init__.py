"""``fleet.utils.recompute`` of the port."""
from .utils import recompute

__all__ = ["recompute"]
