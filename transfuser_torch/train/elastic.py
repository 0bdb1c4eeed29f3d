"""Elastic-style crash capture for training entry points (a copy of
transfuser_tpu/train/elastic.py, with the process index read from
torch.distributed).

The reference decorates its train main with
``torch.distributed.elastic.multiprocessing.errors.record``
(train.py:19-26): on an uncaught exception the worker writes a structured
error file (message, traceback, rank, host, pid, timestamp) that the
launcher surfaces instead of a silent death. ``@record`` wraps any
callable; the error-file path comes from ``TPU_ELASTIC_ERROR_FILE`` (or
``TORCHELASTIC_ERROR_FILE`` for drop-in launcher compat), defaulting to
``crash_<pid>.json`` under the system temp dir. The process index is
torch.distributed's rank when a process group is initialised, else taken
from common launcher env vars. The timestamp is in seconds since the
epoch, which torchrun reads back from ``TORCHELASTIC_ERROR_FILE`` (the
JAX package writes an ISO date there).
"""

from __future__ import annotations

import functools
import json
import os
import socket
import sys
import time
import traceback
from typing import Any, Callable, Optional, TypeVar

import torch.distributed as dist

F = TypeVar("F", bound=Callable[..., Any])


def _process_index() -> int:
    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    for var in ("RANK", "JAX_PROCESS_INDEX", "TPU_WORKER_ID"):
        if os.environ.get(var):
            try:
                return int(os.environ[var])
            except ValueError:
                pass
    return 0


def error_file_path() -> str:
    import tempfile
    return (os.environ.get("TPU_ELASTIC_ERROR_FILE")
            or os.environ.get("TORCHELASTIC_ERROR_FILE")
            or os.path.join(tempfile.gettempdir(),
                            f"crash_{os.getpid()}.json"))


def write_error_file(exc: BaseException,
                     path: Optional[str] = None) -> str:
    """Serialize an exception into the elastic error-file schema."""
    path = path or error_file_path()
    payload = {
        "message": {
            "message": f"{type(exc).__name__}: {exc}",
            "extraInfo": {
                "py_callstack": "".join(traceback.format_exception(
                    type(exc), exc, exc.__traceback__)),
                # seconds since the epoch, as torchrun parses it
                "timestamp": str(int(time.time())),
            },
        },
        "rank": _process_index(),
        "host": socket.gethostname(),
        "pid": os.getpid(),
        "argv": sys.argv,
    }
    try:
        with open(path, "w") as f:
            json.dump(payload, f, indent=2)
    except OSError:
        # never mask the original failure with a reporting failure
        traceback.print_exc()
    return path


def record(fn: F) -> F:
    """Decorator: on an uncaught exception, write the structured error
    file, print its location, and re-raise (reference @record)."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except SystemExit:
            raise
        except BaseException as exc:
            path = write_error_file(exc)
            print(f"[elastic] worker crash recorded to {path}",
                  file=sys.stderr)
            raise
    return wrapper  # type: ignore[return-value]
