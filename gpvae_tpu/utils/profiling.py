"""Tracing / profiling hooks.

The reference's only observability is a graph dump to TensorBoard with no
scalar summaries and no timers (``tf.summary.FileWriter``,
src/Models/Full_GP_VAE_dynamic_time.py:364; SURVEY.md §5 tracing).  Here:

* :func:`trace` — context manager around ``jax.profiler`` producing a
  TensorBoard/XProf trace of the wrapped steps;
* :class:`StepTimer` — steps/sec + per-step wall time with device sync;
* :func:`cholesky_flops` — the TFLOP accounting used by bench.py
  (N * T^3 / 3 useful FLOPs per batched factorization);
* :func:`device_memory_stats` — live/peak HBM from the device API;
* :func:`card_info` — the GPU's name and power limit, to print beside
  every device number.
"""
from __future__ import annotations

import contextlib
import subprocess
import time

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile everything inside the block: ``with trace('/tmp/prof'): ...``
    then inspect with TensorBoard or xprof."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class StepTimer:
    """Wall-clock steps/sec with an explicit device barrier on read.

    Usage::

        timer = StepTimer()
        for batch in batches:
            state, metrics = step(state, batch)
            timer.tick()
            if step_idx % 500 == 0:
                print(timer.report(metrics["loss"]))
    """

    def __init__(self):
        self._t0 = time.perf_counter()
        self._ticks = 0

    def tick(self, n: int = 1):
        self._ticks += n

    def report(self, sync_on=None) -> dict:
        if sync_on is not None:
            jax.block_until_ready(sync_on)
        now = time.perf_counter()
        dt = now - self._t0
        out = {
            "steps_per_sec": self._ticks / max(dt, 1e-9),
            "elapsed_s": dt,
            "steps": self._ticks,
        }
        self._t0 = now
        self._ticks = 0
        return out


def cholesky_flops(n: int, t: int) -> float:
    """Useful FLOPs of a batched T x T Cholesky (N * T^3 / 3)."""
    return n * (t ** 3) / 3.0


def device_memory_stats(device=None) -> dict:
    """Live/peak bytes in device memory (empty dict if unsupported)."""
    device = device or jax.devices()[0]
    stats = getattr(device, "memory_stats", lambda: None)()
    if not stats:
        return {}
    return {
        k: stats[k]
        for k in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")
        if k in stats
    }


def card_info() -> str:
    """``name, power.limit`` of each GPU, as ``nvidia-smi`` reports them
    (one line per card).  A card below its maximum power limit runs
    slower under load, so the limit belongs beside every time."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
