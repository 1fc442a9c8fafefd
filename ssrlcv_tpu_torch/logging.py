"""CSV logger with state markers, telemetry hooks and a heartbeat thread.

The port's own copy of ``ssrlcv_tpu/logging.py``, which replicates the
reference Logger (Logger.hpp:30-339, Logger.cpp): CSV rows
``<epoch-ms>,<tag>,<payload>`` with tags comment/state/info/warning/error,
``log_state`` begin/end timeline markers for offline phase timing, a
background heartbeat thread, and memory accounting.  Device memory comes
from ``torch.cuda.memory_stats`` per visible CUDA device; phase tracing
can add a ``torch.profiler.record_function`` range, as the JAX logger adds
a ``jax.profiler`` trace annotation.  The rows are the JAX logger's.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from typing import Optional

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
    def phase(self, name: str, profile: bool = False):
        """state begin/end pair and an info row with the host seconds; with
        ``profile`` the block is also a ``torch.profiler`` range."""
        self.log_state(f"{name}:begin")
        t0 = time.perf_counter()
        if profile:
            import torch.profiler

            with torch.profiler.record_function(name):
                yield
        else:
            yield
        dt = time.perf_counter() - t0
        self.log_state(f"{name}:end")
        self.info(f"{name} took {dt:.3f}s")

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


# Global logger instance (the reference exposes a global ``logger``,
# Logger.cpp:4); the command line sets its directory.
logger = Logger()
