"""Command-line tools of the port: the elastic drill (``faultinject``) and
its training worker (``elastic_ckpt_worker``), run with ``python -m``."""
