"""``paddle.distributed.launch`` of the port: ``python -m
paddle_tpu_torch.distributed.launch --nproc_per_node N script.py``
(``main.py``)."""
from .main import launch, parse_args  # noqa: F401
