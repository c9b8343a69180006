"""Serving accounting of the port (counterpart of
:mod:`chainermn_tpu.observability`)."""
