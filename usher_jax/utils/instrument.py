"""Tracing / profiling: Chrome-trace scopes + stage timers.

Parity with the reference's Instrumentor (src/Instrumentor.h:37-139, enabled
by -DSAVE_PROFILE and the TIMEIT() macro) and the coarse `Timer` that prints
"Completed in N msec" after each stage (src/usher_graph.hpp:15-31).

  - `Instrumentor.begin_session(path)` / `end_session()` write the same
    chrome://tracing JSON the reference emits ({"otherData": {},
    "traceEvents": [...]} with "ph": "X" duration events in microseconds).
  - `timeit(name)` is the TIMEIT() macro: a context manager recording a
    trace scope (no-op when no session is active); `record_span` records a
    stage that is not one block of code.
  - `Timer` mirrors the reference Timer: Start()/Stop() in milliseconds.
  - Sessions can be armed externally with USHER_JAX_PROFILE=<path> — the
    CLIs call `maybe_begin_session_from_env()` at startup.
  - `enable_compile_cache()` turns on JAX's persistent compilation cache.
  - `device_trace(logdir)` wraps jax.profiler for XLA-level traces of the
    device kernels (viewable in TensorBoard/XProf).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time


class Instrumentor:
    _instance = None

    def __init__(self):
        self._f = None
        self._count = 0
        self._lock = threading.Lock()

    @classmethod
    def get(cls) -> "Instrumentor":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    @property
    def active(self) -> bool:
        return self._f is not None

    def begin_session(self, filepath: str = "profile.json") -> None:
        self._f = open(filepath, "w")
        self._f.write('{"otherData": {},"traceEvents":[')
        self._f.flush()
        self._count = 0

    def end_session(self) -> None:
        if self._f is None:
            return
        self._f.write("]}")
        self._f.close()
        self._f = None

    def write_profile(self, name: str, start_us: int, end_us: int) -> None:
        if self._f is None:
            return
        with self._lock:
            if self._count > 0:
                self._f.write(",")
            self._count += 1
            self._f.write(json.dumps({
                "cat": "function",
                "dur": end_us - start_us,
                "name": name.replace('"', "'"),
                "ph": "X",
                "pid": 0,
                "tid": threading.get_ident() & 0xFFFFFFFF,
                "ts": start_us,
            }))
            self._f.flush()


@contextlib.contextmanager
def timeit(name: str):
    """The TIMEIT() macro: records a duration event when a session is
    active; near-zero cost otherwise."""
    inst = Instrumentor.get()
    if not inst.active:
        yield
        return
    start = now_us()
    try:
        yield
    finally:
        inst.write_profile(name, start, now_us())


def now_us() -> int:
    return time.time_ns() // 1000


def record_span(name: str, start_us: int) -> int:
    """Record [start_us, now] as a duration event when a session is active
    (for stages that are not one block of code).  Returns now, the start
    of the next stage."""
    end = now_us()
    Instrumentor.get().write_profile(name, start_us, end)
    return end


class Timer:
    """Reference src/usher_graph.hpp:15-31: Start(); ...; Stop() -> msec."""

    def __init__(self):
        self._t0 = time.time()

    def start(self) -> None:
        self._t0 = time.time()

    def stop(self) -> int:
        return int((time.time() - self._t0) * 1000)

    def report(self, stream=None) -> int:
        """Print the reference's stage line: 'Completed in N msec'."""
        ms = self.stop()
        print(f"Completed in {ms} msec \n", file=stream or sys.stderr)
        return ms


# <repo root>/.jax_cache: a fixed path, because the cache key includes it
_DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str | None:
    """Turn on JAX's persistent compilation cache, so a repeat run of a CLI
    or the benchmark skips XLA compilation.  Where JAX_COMPILATION_CACHE_DIR
    is set, JAX reads it itself and nothing is set here; otherwise the cache
    is <repo root>/.jax_cache.  Returns the directory set, or None."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    try:
        os.makedirs(_DEFAULT_CACHE_DIR, exist_ok=True)
    except OSError:  # read-only install: run without a cache
        return None
    import jax
    jax.config.update("jax_compilation_cache_dir", _DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return _DEFAULT_CACHE_DIR


def maybe_begin_session_from_env() -> bool:
    """Arm chrome-trace profiling when USHER_JAX_PROFILE=<path> is set;
    registers end_session at exit."""
    path = os.environ.get("USHER_JAX_PROFILE", "")
    if not path:
        return False
    inst = Instrumentor.get()
    if not inst.active:
        inst.begin_session(path)
        import atexit
        atexit.register(inst.end_session)
    return True


@contextlib.contextmanager
def device_trace(logdir: str):
    """XLA-level device profiling via jax.profiler (TensorBoard format)."""
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
