"""Retry scheduler — capped full-jitter exponential backoff.

The port's own copy of ``backoff_full_jitter`` from
``fluentbit_tpu/core/scheduler.py``. The engine's retries are loop
timers that fire after this delay (``Engine._schedule_retry``); the
token bucket of the reference's module belongs to the qos plane, which
the port does not have yet.

Reference: src/flb_scheduler.c:253-300 (backoff_full_jitter; random
seconds in [base, min(cap, base * 2^attempt)] plus one), base
FLB_SCHED_BASE=5s and cap FLB_SCHED_CAP=2000s
(include/fluent-bit/flb_scheduler.h:29-30).
"""

from __future__ import annotations

import random
from typing import Optional


def backoff_full_jitter(base: float, cap: float, attempt: int,
                        rng: Optional[random.Random] = None) -> float:
    """Delay in seconds for retry number ``attempt`` (1-based).

    Never before ``min(base, exp) + 1`` (the draw is from [base, exp],
    then one second is added), and never past ``cap + 1``: the envelope
    ``min(cap, base * 2^attempt)`` does not shrink as attempts grow. A
    ``base`` above ``cap`` draws from [cap, cap]."""
    attempt = max(1, attempt)
    exp = min(cap, base * (2 ** attempt))
    r = rng or random
    return r.uniform(min(base, exp), exp) + 1.0
