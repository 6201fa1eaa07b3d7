"""Labelled stopwatch (PyTorch port of
``mlmcpathintegral_tpu/utils/timer.py``; reference src/common/timer.{hh,cc}).

CUDA work is asynchronous: call :func:`sync` on a region's outputs before
stopping a timer around it.
"""

from __future__ import annotations

import time

import torch


class Timer:

    def __init__(self, label: str = ""):
        self.label = label
        self.reset()

    def reset(self):
        self._elapsed = 0.0
        self._running = False
        self._t0 = None

    def start(self):
        self._t0 = time.monotonic()
        self._running = True

    def stop(self):
        if self._running:
            self._elapsed += time.monotonic() - self._t0
            self._running = False

    @property
    def elapsed(self) -> float:
        if self._running:
            return self._elapsed + (time.monotonic() - self._t0)
        return self._elapsed

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    def __str__(self):
        return f"[timer {self.label}] : {self.elapsed:.4f} s"


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _leaves(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _leaves(t)


def sync(tree):
    """Wait until the work producing ``tree`` is done: synchronise every
    CUDA device holding one of its tensors (CPU tensors are ready when
    they are returned)."""
    devices = {t.device for t in _leaves(tree) if t.is_cuda}
    for d in devices:
        torch.cuda.synchronize(d)
    return tree
