"""Tracing / profiling helpers (SURVEY.md §5).

Reference: absent (at most time.time() prints). Here:
  * `trace(logdir)` — context manager around `jax.profiler.trace` producing
    TensorBoard/Perfetto traces of the XLA programs;
  * `Timer` / `time_fn` — wall clock fenced with `jax.block_until_ready`
    (JAX dispatches asynchronously; without the fence a timing measures
    the enqueue);
  * `steps_per_second` — the throughput primitive;
  * `gpu_name_and_power_limit` — the card's name and power limit, to
    print beside every number measured on it.
"""

from __future__ import annotations

import contextlib
import subprocess
import time
from typing import Callable

import jax


@contextlib.contextmanager
def trace(logdir: str, create_perfetto_link: bool = False):
    """Profile a block: `with trace('/tmp/tb'): run()` then inspect in
    TensorBoard (Profile tab) or Perfetto."""
    jax.profiler.start_trace(logdir, create_perfetto_link=create_perfetto_link)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Timer:
    """Fenced timer: `with Timer() as t: out = f(); t.block_on(out)`."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.elapsed = None
        return self

    def block_on(self, value):
        jax.block_until_ready(value)
        self.elapsed = time.perf_counter() - self.t0
        return value

    def __exit__(self, *exc):
        if self.elapsed is None:
            self.elapsed = time.perf_counter() - self.t0
        return False


def time_fn(fn: Callable, *args, repeats: int = 3, warmup: int = 1, **kw):
    """Median fenced wall time of fn(*args, **kw) (compile excluded by the
    warmup calls). Returns (median_seconds, last_output)."""
    out = None
    for _ in range(warmup):
        out = jax.block_until_ready(fn(*args, **kw))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args, **kw))
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2], out


def steps_per_second(
    fn: Callable, steps_per_call: int, *args, repeats: int = 3, **kw
) -> float:
    """Throughput of a rollout-like fn: steps_per_call / median_time."""
    dt, _ = time_fn(fn, *args, repeats=repeats, **kw)
    return steps_per_call / dt


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi`'s name and power limit of the card(s), read in a child
    process (which does not touch JAX). A card set below its maximum power
    runs slower under load, so every timing is reported beside this."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
