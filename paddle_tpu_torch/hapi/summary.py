"""``paddle.summary``: the port of ``paddle_tpu/hapi/summary.py``, a table of
a network's parameters with the total and trainable counts."""
from __future__ import annotations


def summary(net, input_size=None, dtypes=None, input=None):  # noqa: A002
    total_params = 0
    trainable_params = 0
    rows = []
    for name, p in net.named_parameters():
        n = p.size
        total_params += n
        if not p.stop_gradient:
            trainable_params += n
        rows.append((name, tuple(p.shape), n))
    width = max((len(r[0]) for r in rows), default=20) + 2
    lines = [f"{'Param':<{width}}{'Shape':<20}{'Count':>12}"]
    for name, shape, n in rows:
        lines.append(f"{name:<{width}}{str(shape):<20}{n:>12,}")
    lines.append("-" * (width + 32))
    lines.append(f"Total params: {total_params:,}")
    lines.append(f"Trainable params: {trainable_params:,}")
    print("\n".join(lines))
    return {"total_params": total_params,
            "trainable_params": trainable_params}
