"""Attention operators of the port: the paged KV-cache plumbing, the two
hand-written Hopper kernels (``csrc/``) with their wrappers and plain
versions, and the prefill routing."""
