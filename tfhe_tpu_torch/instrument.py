"""Spans and counters of the port: what a profiler trace and a run's log
read of its stages and dispatch decisions.

A leaf: it imports nothing of the package, so that any module may import
it (`utils` imports `api`, which imports `bootstrap`).

* `span(name)` / `spanned(name)`: a `torch.profiler.record_function` span
  around a block or a function, opened only while a profiler records
  (`torch.profiler.profile`); otherwise one flag check and nothing else.
  The spans land in the profiler's own trace, on the clock of the CUDA
  kernels, so a trace ties every device operation and idle gap to the
  stage that was open on the host. The stages of a gate bootstrap:
  `tfhe.gate` (a bootstrapped gate, its affine combination included),
  `tfhe.modswitch` (the mod switch, the test vector and the trivial
  accumulator), `tfhe.rotation` (the blind rotation), `tfhe.enqueue`
  (a rotation wrapper's C call, which enqueues its launches),
  `tfhe.extract` (the sample extraction) and `tfhe.keyswitch`.
* One registry of integer counters by name (`count`, `counts`, `reset`):
  the kernel wrappers' launches under the names of
  `ops.kernel_wrappers()`; `path.<form>`, one a rotation by the path it
  took (`baked`, `dense`, `compact`, `plain`; `mk_compact`, `mk_chunk`,
  `mk_step`, `mk_plain`); `dots.clustered`, one a C entry call whose
  dots launches run in thread-block clusters (`ops/dots.py:dots_args`);
  `dots.per_sm.<r>`, one a C entry call of the dots by the r 64-row
  blocks (1 or 2) an SM holds at its M (`ops/dots.py:blocks_per_sm`);
  `dots.row_tile.<r>`, one a C entry call of the dots by the r batch rows
  (64 or 128) a block owns (`ops/dots.py:row_tile`); and `built.<table>`,
  one a cache miss of a cached table or library build (`cached_build`),
  whose host seconds `seconds()` keeps. `ops.reset_launches()` /
  `ops.launches()` read the counts, `ops.build_seconds()` the seconds; the
  entry points log both.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import time

import torch

_counts: collections.Counter = collections.Counter()
_seconds: collections.Counter = collections.Counter()


def recording() -> bool:
    """Whether a profiler records: the flag `torch.profiler.profile` sets
    while it runs."""
    return torch.autograd.profiler._is_profiler_enabled


_NO_SPAN = contextlib.nullcontext()  # reusable: it holds no state


def span(name: str):
    """A context manager: a profiler span named `name` while a profiler
    records, else a no-op."""
    if recording():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def spanned(name: str):
    """Decorator: every call of the function inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    _counts[name] += n


def counts(names=None) -> dict:
    """The nonzero counters since the last `reset`, by name; those of
    `names` alone if given (the launches of some kernels)."""
    return {name: n for name, n in _counts.items()
            if n and (names is None or name in names)}


def seconds() -> dict:
    """Host seconds of the `built.*` counters' cache misses since the last
    `reset`, by counter."""
    return {name: s for name, s in _seconds.items() if s}


def reset() -> None:
    _counts.clear()
    _seconds.clear()


def cached_build(name: str):
    """Decorator: `functools.lru_cache(maxsize=None)` whose misses count
    in `built.<name>` and time their host seconds. A hit is the cache's
    own lookup and costs nothing more."""
    key = f"built.{name}"

    def wrap(fn):
        @functools.wraps(fn)
        def build(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                _counts[key] += 1
                _seconds[key] += time.perf_counter() - t0
        return functools.lru_cache(maxsize=None)(build)
    return wrap
