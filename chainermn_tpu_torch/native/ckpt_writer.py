"""ctypes wrapper over the native async checkpoint writer
(``src/ckpt_writer.cpp``; counterpart of
:mod:`chainermn_tpu.native.ckpt_writer`).

A train step on the card takes tens of milliseconds; making a snapshot
durable on disk takes far longer. The writer moves the write -> fsync ->
atomic-rename sequence onto a C++ worker thread with a bounded queue, so
:meth:`AsyncCheckpointWriter.submit` returns once the bytes are copied
and training goes on while the snapshot becomes durable. Failures are
collected and raised at :meth:`~AsyncCheckpointWriter.wait`, where
durability is needed; a writer used after
:meth:`~AsyncCheckpointWriter.finalize` raises.
"""

from __future__ import annotations

import ctypes

from chainermn_tpu_torch.native import lib_path

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(lib_path("ckpt_writer")))
        lib.cw_init.restype = ctypes.c_void_p
        lib.cw_init.argtypes = [ctypes.c_int]
        lib.cw_submit.restype = ctypes.c_int
        lib.cw_submit.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_longlong,
        ]
        lib.cw_pending.restype = ctypes.c_int
        lib.cw_pending.argtypes = [ctypes.c_void_p]
        lib.cw_wait.restype = ctypes.c_int
        lib.cw_wait.argtypes = [ctypes.c_void_p]
        lib.cw_finalize.restype = None
        lib.cw_finalize.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


class AsyncCheckpointWriter:
    """Background durable-file writer (see the module docstring).

    ``queue_depth`` bounds the buffered snapshots; a full queue makes
    :meth:`submit` block (backpressure rather than unbounded host memory
    when the disk cannot keep up with the snapshot cadence).
    """

    def __init__(self, queue_depth: int = 2) -> None:
        self._h = _load().cw_init(queue_depth)

    def _handle(self):
        # finalize() frees the C writer; a NULL handle would crash the
        # library, so liveness is checked here
        if not self._h:
            raise RuntimeError("AsyncCheckpointWriter used after finalize()")
        return self._h

    def submit(self, path: str, data: bytes) -> None:
        """Enqueue ``data`` to become the durable content of ``path``
        (written to a temporary file, fsynced, renamed into place)."""
        rc = _load().cw_submit(self._handle(), str(path).encode(), data,
                               len(data))
        if rc != 0:
            raise RuntimeError("submit rejected (writer shutting down)")

    @property
    def pending(self) -> int:
        """Snapshots accepted but not yet durable."""
        return _load().cw_pending(self._handle())

    def wait(self) -> None:
        """Block until every submitted snapshot is durable; raise if any
        write failed since the last wait."""
        failures = _load().cw_wait(self._handle())
        if failures:
            raise RuntimeError(
                f"{failures} async checkpoint write(s) failed "
                "(disk full, permissions, or the directory removed?)")

    def finalize(self) -> None:
        """Drain, stop the worker thread and free the writer."""
        if self._h:
            _load().cw_finalize(self._h)
            self._h = None

    def __del__(self):
        try:
            self.finalize()
        except (RuntimeError, OSError):
            pass
