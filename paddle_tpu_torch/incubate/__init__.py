"""``paddle.incubate``: so far its ``autograd`` (the rest of the reference's
``paddle_tpu/incubate`` waits for ROADMAP queue 1)."""
from . import autograd  # noqa: F401
