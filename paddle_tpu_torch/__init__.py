"""paddle_tpu_torch: the PyTorch/CUDA port of ``paddle_tpu`` for NVIDIA Hopper.

The package mirrors ``paddle_tpu``'s module paths so each counterpart is
easy to find (``models/gpt.py``, ``ops/paged_attention.py``,
``serving/generation/engine.py``, ...). It imports ``torch`` and numpy only:
never ``jax`` and nothing of ``paddle_tpu``. Every TPU (Pallas) kernel on a
ported path is a hand-written CUDA C++ kernel under ``csrc/``, built with
``nvcc`` for ``sm_90a`` at first use (``ops/_build.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a CUDA device and without that argument they raise.
"""
__version__ = "0.1.0"
