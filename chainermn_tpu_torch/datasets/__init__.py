"""Data helpers of the port (counterpart of :mod:`chainermn_tpu.datasets`)."""
