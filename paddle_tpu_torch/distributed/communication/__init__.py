"""``paddle.distributed.communication`` of the port: the eager
collectives (``collective.py``)."""
from . import collective  # noqa: F401
from .collective import (  # noqa: F401
    P2POp, ReduceOp, all_gather, all_gather_object, all_reduce, all_to_all,
    all_to_all_single, barrier, batch_isend_irecv, broadcast,
    broadcast_object_list, gather, irecv, isend, recv, reduce,
    reduce_scatter, scatter, scatter_object_list, send, stream,
)
