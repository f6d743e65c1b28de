"""Timed scopes, device traces and structured logging (port of
``pcmi_tpu/utils/profiling.py``).

``scope`` times a block on the host clock; with ``sync=True`` it first
waits for the work already queued on the card (``torch.cuda.synchronize``
once CUDA is in use), so the time covers execution, not only the launches.
Times aggregate by name (``stats``). ``device_trace`` records a
``torch.profiler`` trace (host and, with a card, CUDA activity) into a
directory, viewable in TensorBoard or Perfetto.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

logger = logging.getLogger("pcmi_tpu_torch")

_STATS: Dict[str, list] = defaultdict(list)


def _device_sync() -> None:
    """Wait for every kernel queued on the current card, if CUDA is in
    use in this process."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def scope(name: str, sync: bool = True, log: bool = False):
    """Time a block under ``name``; ``sync=True`` waits for the device's
    queued work before reading the clock."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync:
            _device_sync()
        dt = time.perf_counter() - t0
        _STATS[name].append(dt)
        if log:
            logger.info("scope %s: %.1f ms", name, dt * 1e3)


def stats() -> Dict[str, dict]:
    out = {}
    for name, times in _STATS.items():
        out[name] = {
            "count": len(times),
            "total_s": sum(times),
            "mean_ms": 1e3 * sum(times) / len(times),
            "last_ms": 1e3 * times[-1],
        }
    return out


def reset_stats() -> None:
    _STATS.clear()


def dump_stats(path: Optional[str] = None) -> str:
    s = json.dumps(stats(), indent=2, sort_keys=True)
    if path:
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(s)
    return s


@contextlib.contextmanager
def device_trace(logdir: str):
    """Record a ``torch.profiler`` trace of the block into ``logdir``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield


def setup_logging(level: int = logging.INFO, path: Optional[str] = None):
    """Console (and optional file) logging for the package's logger."""
    handlers: list = [logging.StreamHandler()]
    if path:
        handlers.append(logging.FileHandler(path))
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
        handlers=handlers,
        force=True,
    )
    return logger
