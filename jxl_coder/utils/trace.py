"""Tracing / profiling / structured logging (SURVEY.md §5.1, §5.5).

The reference wires none of this (highway's profiler headers are
vendored but never called); we provide:

- `span(name)` — lightweight nested stage timers collected into a
  process-global registry; `report()` renders a summary and `reset()`
  clears it.  Near-zero overhead when disabled (the default).
- `device_trace(logdir)` — context manager around `jax.profiler` for
  XLA device traces viewable in TensorBoard/Perfetto.
- `log` — a namespaced `logging.Logger`; `enable_json_logs()` switches
  the handler to one-JSON-object-per-line for log pipelines.
"""

from __future__ import annotations

import contextlib
import json
import logging
import threading
import time
from collections import defaultdict

log = logging.getLogger("jxl_coder")

_enabled = False
_lock = threading.Lock()
_stats = defaultdict(lambda: [0, 0.0])  # name -> [calls, total_s]
_local = threading.local()


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def reset() -> None:
    with _lock:
        _stats.clear()


@contextlib.contextmanager
def span(name: str):
    """Time a stage.  Nested spans get dotted names (decode.entropy)."""
    if not _enabled:
        yield
        return
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    full = ".".join(stack + [name])
    stack.append(name)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        stack.pop()
        with _lock:
            s = _stats[full]
            s[0] += 1
            s[1] += dt


def report() -> str:
    with _lock:
        rows = sorted(_stats.items(), key=lambda kv: -kv[1][1])
        lines = [f"{'span':<40} {'calls':>8} {'total s':>10} {'avg ms':>9}"]
        for name, (calls, total) in rows:
            lines.append(f"{name:<40} {calls:>8} {total:>10.3f} "
                         f"{total / calls * 1e3:>9.2f}")
    return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture an XLA profiler trace for the enclosed region."""
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": self.formatTime(record),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out)


def enable_json_logs(level: int = logging.INFO) -> None:
    handler = logging.StreamHandler()
    handler.setFormatter(_JsonFormatter())
    log.handlers[:] = [handler]
    log.setLevel(level)
