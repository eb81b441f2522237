"""Logging, metrics and profiling hooks (``utils/observability.py``):

  * ``get_logger``    -- namespaced stderr logging with one-line setup;
  * ``Metrics``       -- process-local counters, gauges and timings with a
                         ``summary()`` dict;
  * ``StepTimer``     -- wall time per step that waits for the card first;
  * ``profile_trace`` -- a ``torch.profiler`` capture (CPU and CUDA
                         activity) written as a Chrome trace into a
                         directory; a no-op without one.
"""
from __future__ import annotations

import contextlib
import logging
import os
import sys
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

_LOG_FORMAT = "%(asctime)s %(name)s %(levelname)s %(message)s"


def get_logger(name: str = "fantasy_world_tpu_torch",
               level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_LOG_FORMAT))
        logger.addHandler(handler)
        logger.setLevel(level)
        logger.propagate = False
    return logger


class Metrics:
    """Counters, gauges and timing lists; not thread-safe (the trainer is
    one host thread)."""

    def __init__(self):
        self.counters: Dict[str, float] = defaultdict(float)
        self.gauges: Dict[str, float] = {}
        self._timings: Dict[str, list] = defaultdict(list)

    def count(self, name: str, value: float = 1.0) -> None:
        self.counters[name] += value

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def observe(self, name: str, seconds: float) -> None:
        self._timings[name].append(float(seconds))

    @contextlib.contextmanager
    def timed(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0)

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = dict(self.counters)
        out.update(self.gauges)
        for name, vals in self._timings.items():
            out[f"{name}.count"] = len(vals)
            out[f"{name}.total_s"] = sum(vals)
            out[f"{name}.mean_s"] = sum(vals) / max(1, len(vals))
            out[f"{name}.max_s"] = max(vals)
        return out

    def log_summary(self, logger: Optional[logging.Logger] = None) -> None:
        logger = logger or get_logger()
        summary = self.summary()
        for k in sorted(summary):
            logger.info("%s = %.6g", k, summary[k])


class StepTimer:
    """Per-step wall time that synchronises the card before reading the
    clock (a CUDA launch returns before the work is done)."""

    def __init__(self, name: str = "step",
                 registry: Optional[Metrics] = None):
        self.name = name
        self.registry = registry if registry is not None else Metrics()
        self._t0 = None

    @staticmethod
    def sync() -> None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def start(self) -> None:
        self.sync()
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        self.sync()
        dt = time.perf_counter() - self._t0
        self.registry.observe(self.name, dt)
        return dt


@contextlib.contextmanager
def profile_trace(trace_dir: Optional[str]):
    """torch.profiler over the block when a directory is given (CUDA
    activity too when a card is present), written to
    ``<trace_dir>/trace.json`` for chrome://tracing or Perfetto; otherwise
    a no-op."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
