"""CSV logger with state markers, telemetry hooks and a heartbeat thread.

The port's own copy of ``ssrlcv_tpu/logging.py``, which replicates the
reference Logger (Logger.hpp:30-339, Logger.cpp): CSV rows
``<epoch-ms>,<tag>,<payload>`` with tags comment/state/info/warning/error,
``log_state`` begin/end timeline markers for offline phase timing, a
background heartbeat thread, and memory accounting.  Device memory comes
from ``torch.cuda.memory_stats`` per visible CUDA device.  The rows are the
JAX logger's.

Spans (``Logger.span``) mark the program's layers on a profiler's
timeline and write no row.  A span is off unless ``torch.profiler`` is
recording or a listener is registered; off, it costs one check.  While the
profiler records, a span is a ``torch.profiler.record_function`` range named
``stage.<name>``, on the clock of the device trace, so every gap in the
device's work can be put down to the innermost span the host was in; its
parent is the span around it, and its job the outermost range.  Listeners
(``add_span_listener``) are called as ``fn(range_name, begin)`` when a span
begins and ends, in nesting order.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Optional

import torch

_LEVELS = {"error": 1, "warning": 2, "info": 3, "debug": 4}


class Logger:
    """Thread-safe CSV logger (mutex-serialised like Logger.cpp:300-420)."""

    def __init__(self, log_dir: str = "out", filename: str = "ssrlcv.log", level: str = "info"):
        self.log_dir = log_dir
        self.path = os.path.join(log_dir, filename)
        self.level = _LEVELS.get(level, 3)
        self._lock = threading.Lock()
        self._file = None
        self._bg_thread: Optional[threading.Thread] = None
        self._bg_stop = threading.Event()
        self._span_listeners: tuple = ()

    def _write(self, tag: str, payload: str):
        with self._lock:
            if self._file is None:
                os.makedirs(self.log_dir, exist_ok=True)
                self._file = open(self.path, "a", buffering=1)
            ms = int(time.time() * 1000)
            payload = str(payload).replace("\n", " ")
            self._file.write(f"{ms},{tag},{payload}\n")

    def info(self, msg: str):
        if self.level >= 3:
            self._write("info", msg)

    def warn(self, msg: str):
        if self.level >= 2:
            self._write("warning", msg)

    def err(self, msg: str):
        if self.level >= 1:
            self._write("error", msg)

    def comment(self, msg: str):
        self._write("comment", msg)

    def log_state(self, state: str):
        """Timeline marker row (Logger.cpp:333-360) for offline phase timing."""
        self._write("state", state)

    @contextmanager
    def phase(self, name: str):
        """state begin/end pair and an info row with the host seconds; the
        block is also a span."""
        self.log_state(f"{name}:begin")
        t0 = time.perf_counter()
        with self.span(name):
            yield
        dt = time.perf_counter() - t0
        self.log_state(f"{name}:end")
        self.info(f"{name} took {dt:.3f}s")

    def span(self, name: str):
        """A context manager over one of the program's layers: the profiler
        range ``stage.<name>`` while the profiler records, and a call of
        every listener at its begin and end; nothing otherwise."""
        if self._span_listeners or _profiler_enabled():
            return _Span("stage." + name, self._span_listeners)
        return _OFF

    def add_span_listener(self, fn):
        """Call ``fn(range_name, begin)`` at every span's begin (True) and
        end (False)."""
        self._span_listeners = self._span_listeners + (fn,)

    def remove_span_listener(self, fn):
        self._span_listeners = tuple(f for f in self._span_listeners if f is not fn)

    def log_device_memory(self):
        """Device memory accounting (the LOG_MEM analogue,
        Logger.hpp:114-130): per visible CUDA device, bytes in use and the
        peak.  Writes nothing on a host without a CUDA device."""
        try:
            import torch

            for d in range(torch.cuda.device_count()):
                stats = torch.cuda.memory_stats(d)
                if stats:
                    used = stats.get("allocated_bytes.all.current", -1)
                    self.info(f"device {d} mem bytes_in_use={used}"
                              f" peak={stats.get('allocated_bytes.all.peak', -1)}")
        except RuntimeError as e:  # telemetry must never take the pipeline down
            self.warn(f"device memory stats unavailable: {e}")

    def start_background_logging(self, rate_s: float = 1.0):
        """Heartbeat thread (startBackgoundLogging, Logger.cpp:782-840)."""
        if self._bg_thread is not None:
            return

        def looper():
            while not self._bg_stop.wait(rate_s):
                self._write("comment", "heartbeat")

        self._bg_stop.clear()
        self._bg_thread = threading.Thread(target=looper, daemon=True)
        self._bg_thread.start()

    def stop_background_logging(self):
        if self._bg_thread is not None:
            self._bg_stop.set()
            self._bg_thread.join(timeout=5)
            self._bg_thread = None

    def close(self):
        """Stop the heartbeat and close the file (the next row reopens it)."""
        self.stop_background_logging()
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None


_profiler_enabled = torch._C._autograd._profiler_enabled
_OFF = nullcontext()


class _Span:
    """An open span: its profiler range (while the profiler records) and
    the listeners it tells."""

    __slots__ = ("name", "listeners", "range")

    def __init__(self, name: str, listeners: tuple):
        self.name, self.listeners, self.range = name, listeners, None

    def __enter__(self):
        if _profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        for fn in self.listeners:
            fn(self.name, True)

    def __exit__(self, *exc):
        for fn in reversed(self.listeners):
            fn(self.name, False)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


# Global logger instance (the reference exposes a global ``logger``,
# Logger.cpp:4); the command line sets its directory.
logger = Logger()
