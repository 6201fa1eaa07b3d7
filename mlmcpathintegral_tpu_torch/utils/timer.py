"""Synchronisation, and the program's spans and counters.

CUDA work is asynchronous: call :func:`sync` on a region's outputs before
reading a host clock around it.

While a ``torch.profiler`` session is active (:func:`recording`), the
program records spans (:func:`span`): a name, start and end on
``time.time_ns()`` (the wall clock the profiler stamps its device events
with, so a span says what the host did beside the device's trace), the
parent span, the chunk it belongs to (its outermost span) and attributes.
An attribute may be a device tensor of counts (the screen's accepts, K3's
and K4's rejection rounds): it is read only by :func:`spans`, all of them
in one copy, so recording never waits on the device.  With no profiler
the recorder is off: a span costs one check and records nothing.

A kernel's launch function is recorded by :func:`recorded_launch`, which
also hands the kernel, while it records, the counts of its rejection
loops to add to (:func:`new_round_counts`).
"""

from __future__ import annotations

import collections
import functools
import itertools
import time

import torch

#: the most spans the record keeps; later ones are dropped and counted
MAX_SPANS = 1 << 20

_record: list = []       # finished spans, oldest first
_open: list = []         # the spans entered and not yet left
_next_id = 0
_dropped = 0


def recording() -> bool:
    """Whether the program records its spans: while a ``torch.profiler``
    session is active."""
    return torch.autograd._profiler_enabled()


class Span:
    """One recorded span: ``id``, ``name``, ``start_ns``, ``end_ns``,
    ``parent`` (the enclosing span's id, or None), ``chunk`` (the id of its
    outermost span) and ``attrs``.  Entered as a context manager."""

    __slots__ = ("id", "name", "start_ns", "end_ns", "parent", "chunk",
                 "attrs")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        global _next_id
        self.id = _next_id
        _next_id += 1
        up = _open[-1] if _open else None
        self.parent = up.id if up is not None else None
        self.chunk = up.chunk if up is not None else self.id
        _open.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        global _dropped
        self.end_ns = time.time_ns()
        _open.pop()
        if len(_record) < MAX_SPANS:
            _record.append(self)
        else:
            _dropped += 1
        return False

    def set(self, **attrs):
        """Add attributes (numbers, or device tensors read later)."""
        self.attrs.update(attrs)

    def child(self, name: str, **attrs) -> "Span":
        """A span inside this one, recorded without a second check."""
        return Span(name, attrs)


class _Off:
    """The span of a recorder that is off: false, and records nothing."""

    def __bool__(self):
        return False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass

    def child(self, name: str, **attrs):
        return self


_OFF = _Off()


def span(name: str, **attrs):
    """A span named ``name`` around a ``with`` block, recorded while
    :func:`recording`; otherwise a false object that records nothing, so
    ``if sp:`` guards work only a recording needs."""
    return Span(name, attrs) if recording() else _OFF


def spans() -> list:
    """The recorded spans, oldest first, with every tensor attribute read
    into host numbers (nested lists of the tensor's shape): the pending
    tensors of a device in one stack and one copy, which is one wait on
    it."""
    by_device = {}
    for s in _record:
        for k, v in s.attrs.items():
            if isinstance(v, torch.Tensor):
                by_device.setdefault(v.device, []).append((s, k, v))
    for items in by_device.values():
        flat = torch.cat([v.reshape(-1).to(torch.float64)
                          for _, _, v in items]).cpu()
        at = 0
        for s, k, v in items:
            n = v.numel()
            s.attrs[k] = flat[at:at + n].to(v.dtype).reshape(
                v.shape).tolist()
            at += n
    return list(_record)


def dropped() -> int:
    """Spans left out of a full record."""
    return _dropped


def clear() -> None:
    """Empty the record (an open span is still recorded when it ends)."""
    global _dropped
    _record.clear()
    _dropped = 0


def new_round_counts(n_loops: int, device):
    """The zeroed int64 [n_loops, 3] counts of rejection loops: draws,
    rounds needed, rounds evaluated (csrc/schwinger_sweep.cuh RegCount),
    one row a loop."""
    return torch.zeros((n_loops, 3), dtype=torch.int64, device=device)


#: while the program records, one launch in COUNT_EVERY of each kernel at
#: each shape runs its counted instantiation: the counts cost a K4 launch
#: of the warp design 5-6% and one of K3 2.5% (the block designs 1-1.5%),
#: so counting every launch would slow a traced run's kernels by as much
COUNT_EVERY = 8


def recorded_launch(name: str, n_loops: int, every: int = 1):
    """Record each call of a kernel's launch function or plain version
    (its first argument a tensor of the chains) as span ``name``.  While
    the program records, every ``every``-th recorded call at each shape
    of the first argument (the first one first) gets ``rounds``, zeroed
    :func:`new_round_counts` of its ``n_loops`` rejection loops, to count
    into, and the span keeps them as its attribute ``rounds``; other calls
    get ``rounds`` None.  A shape is sampled on its own, so the levels of
    a run, whose launches take turns, are each counted."""
    def wrap(fn):
        calls = collections.defaultdict(itertools.count)

        @functools.wraps(fn)
        def recorded(first, *args, **kw):
            with span(name) as sp:
                rounds = None
                if sp and next(calls[tuple(first.shape)]) % every == 0:
                    rounds = new_round_counts(n_loops, first.device)
                out = fn(first, *args, rounds=rounds, **kw)
                if rounds is not None:
                    sp.set(rounds=rounds)
            return out
        return recorded
    return wrap


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
