"""Port parity: fault injection, retry/backoff and tier health against the
JAX package's ``core/faults.py`` (identical traces, stats and ledgers)."""
import random

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import faults as ref_faults
from repro.core.pool import TimeLedger as RefLedger
from repro.sim.clock import VirtualClock
from repro_torch.core import faults
from repro_torch.core.pool import TimeLedger


def _run_once(mod, ledger_cls, seed, n_faults):
    clock = VirtualClock()
    ledger = ledger_cls()
    trace = []
    left = [n_faults]

    def fn():
        if left[0] > 0:
            left[0] -= 1
            raise mod.TierFaultError("injected", tier="rdma")
        return 42

    out = mod.call_with_retries(fn, rng=random.Random(seed), ledger=ledger,
                                clock=clock, trace=trace)
    return out, tuple(trace), dict(ledger.seconds), clock.monotonic()


def _fold(xs):
    """Left-to-right float sum, the order the clock and the ledger add in."""
    acc = 0.0
    for x in xs:
        acc += x
    return acc


@given(st.integers(0, 2**31 - 1), st.integers(0, 4))
@settings(max_examples=30, deadline=None)
def test_same_seed_same_schedule_identical_trace(seed, n_faults):
    a = _run_once(faults, TimeLedger, seed, n_faults)
    assert a == _run_once(faults, TimeLedger, seed, n_faults)
    assert a == _run_once(ref_faults, RefLedger, seed, n_faults)
    out, trace, ledger, elapsed = a
    assert out == 42 and len(trace) == n_faults
    assert elapsed == _fold(trace)
    assert ledger.get("retry_backoff", 0.0) == _fold(trace)


def _drive(mod, seed):
    inj = (mod.FaultInjector(seed=seed)
           .fail_reads("rdma", 2, lo=4096, hi=3 * 4096)
           .fail_writes("cxl", 1)
           .fail_completions("rdma", 2)
           .poison_reads("cxl", 1))
    outcome = []
    for off in (0, 4096, 8192, 4096, 16384):
        for call in (lambda: inj.check_read("rdma", off, 4096),
                     lambda: inj.check_write("cxl", off, 4096),
                     lambda: inj.check_completion("rdma")):
            try:
                call()
                outcome.append("ok")
            except mod.TierFaultError as e:
                outcome.append(e.kind)
    return outcome, dict(inj.stats)


@pytest.mark.parametrize("seed", [0, 7])
def test_injector_schedules_and_stats_equal(seed):
    assert _drive(faults, seed) == _drive(ref_faults, seed)


def test_poison_filters_tensor_in_place():
    import torch

    inj = faults.FaultInjector().poison_reads("cxl", 1, lo=4096, hi=8192)
    ref = ref_faults.FaultInjector().poison_reads("cxl", 1, lo=4096, hi=8192)
    data = np.arange(3 * 4096, dtype=np.uint32).astype(np.uint8)
    t = torch.from_numpy(data.copy())
    assert inj.filter_read("cxl", 0, data.nbytes, t)
    assert ref.filter_read("cxl", 0, data.nbytes, data)
    np.testing.assert_array_equal(t.numpy(), data)
    assert inj.stats == ref.stats


def test_tier_health_state_machine_matches():
    def walk(mod):
        clock = VirtualClock()
        h = mod.TierHealth("cxl", clock, failure_threshold=2, cooldown_s=1e-3)
        seen = []
        for step in ("f", "f", "a", "t", "a", "s", "f", "f", "t", "a", "f", "t", "a", "s"):
            if step == "f":
                h.record_failure()
            elif step == "s":
                h.record_success()
            elif step == "t":
                clock.sleep(2e-3)
            seen.append((h.allow() if step == "a" else None, h.state))
        return seen, dict(h.stats)

    assert walk(faults) == walk(ref_faults)


def test_retry_policy_equal():
    for urgent in (False, True):
        for attempt in range(6):
            rr, rg = random.Random(attempt), random.Random(attempt)
            assert (faults.RetryPolicy().backoff_s(attempt, rg, urgent)
                    == ref_faults.RetryPolicy().backoff_s(attempt, rr, urgent))
