"""Bounded retry with exponential backoff + jitter for transient I/O.

The checkpoint saver and the streaming frame producers write through
network filesystems and page caches where a single ``write()`` can fail
transiently (EAGAIN, ENOSPC races, NFS blips) without the whole save
being doomed. :func:`retry_call` retries a callable a bounded number of
times with exponential backoff and multiplicative jitter (decorrelated
start times when many writers retry together); :class:`RetryingWriter`
applies it per ``write()``/``flush()`` on a file-like sink.

Retrying a write assumes the failed call wrote nothing — true for the
fault injectors of the chaos tests (they raise before
touching the sink) and for the common transient errnos, and the CRC
framing downstream catches the pathological partial-write case anyway.

Defaults are overridable via ``REPRO_IO_RETRIES`` (attempt count; ``1``
disables retrying) so a chaos lane or an ops environment can tune the
policy without code changes. The ``sleep`` hook exists so tests assert
backoff schedules without actually sleeping.
"""
from __future__ import annotations

import dataclasses
import os
import random
import time


def _env_attempts(default: int) -> int:
    try:
        return max(1, int(os.environ.get("REPRO_IO_RETRIES", default)))
    except ValueError:
        return default


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """attempts = total tries (1 = no retry); delay_s grows as
    ``base_delay * 2**(try-1)``, capped at ``max_delay``, then scaled by
    ``1 + U[0, jitter)``."""

    attempts: int = 3
    base_delay: float = 0.05
    max_delay: float = 2.0
    jitter: float = 0.5
    retry_on: tuple = (OSError,)

    def delay(self, attempt: int, rng: random.Random) -> float:
        d = min(self.max_delay, self.base_delay * (2.0 ** (attempt - 1)))
        return d * (1.0 + rng.random() * self.jitter)


def default_policy() -> RetryPolicy:
    return RetryPolicy(attempts=_env_attempts(3))


def retry_call(fn, *, policy: RetryPolicy | None = None, on_retry=None,
               sleep=time.sleep, seed: int | None = None):
    """Call ``fn()``; on an exception in ``policy.retry_on``, back off and
    retry up to ``policy.attempts`` total tries, then re-raise the last
    error. ``on_retry(attempt, exc, delay_s)`` observes each retry (the
    telemetry hook); ``seed`` pins the jitter for reproducible tests."""
    policy = policy if policy is not None else default_policy()
    rng = random.Random(seed)
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn()
        except policy.retry_on as e:
            if attempt >= policy.attempts:
                raise
            delay = policy.delay(attempt, rng)
            if on_retry is not None:
                on_retry(attempt, e, delay)
            sleep(delay)


class RetryingWriter:
    """File-like proxy that retries transient ``write()``/``flush()``
    failures per :class:`RetryPolicy`. ``retries`` counts the retries that
    happened (0 on a healthy sink) — surfaced into save telemetry so
    silent degradation stays observable."""

    def __init__(self, f, *, policy: RetryPolicy | None = None, sleep=time.sleep, seed: int | None = None):
        self._f = f
        self._policy = policy if policy is not None else default_policy()
        self._sleep = sleep
        self._rng = random.Random(seed)
        self.retries = 0

    def _retrying(self, fn):
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn()
            except self._policy.retry_on:
                if attempt >= self._policy.attempts:
                    raise
                self.retries += 1
                self._sleep(self._policy.delay(attempt, self._rng))

    def write(self, b):
        return self._retrying(lambda: self._f.write(b))

    def flush(self):
        if hasattr(self._f, "flush"):
            return self._retrying(self._f.flush)

    def __getattr__(self, name):  # fileno, seek, ... pass through untouched
        return getattr(self._f, name)
