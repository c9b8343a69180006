"""Attention and paged-KV primitives of the port (counterpart of
:mod:`chainermn_tpu.ops`)."""
