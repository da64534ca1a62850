"""The port's transfer plane against the JAX package's: the same
note/watch/poll/mark/reset sequence gives equal ledger snapshots
(timestamps aside); and, on the CPU, the sync-debug guard's process-global
accounting — nested and cross-thread scopes, the mode each one sets, the
count of a synchronizing operation's warning or error at its site. Exact
equality (host bookkeeping)."""

import threading
import warnings

import numpy as np
import pytest

from large_scale_recommendation_tpu.obs import transfers as jtx
from large_scale_recommendation_tpu_torch import obs
from large_scale_recommendation_tpu_torch.obs import transfers as ptx
from large_scale_recommendation_tpu_torch.obs.registry import MetricsRegistry
from large_scale_recommendation_tpu_torch.ops import _build

SYNC = "called a synchronizing CUDA operation"


@pytest.fixture
def modes(monkeypatch):
    """The sync-debug modes the guard sets, recorded instead of applied
    (the CPU has none); the port's module defaults restored after."""
    seen = []
    monkeypatch.setattr(ptx, "_set_sync_debug_mode", seen.append)
    prev = ptx.get_transfers()
    yield seen
    ptx.set_transfers(prev)
    assert ptx._SYNC.armed == 0 and ptx._SYNC.allowed == 0


class Cache:
    """An object with ``_cache_size()`` (a jitted function's protocol)."""

    def __init__(self):
        self.n = 1

    def _cache_size(self):
        return self.n


def _untimed(snap):
    snap = dict(snap, time=None)
    snap["retraces"] = dict(snap["retraces"], ring=[
        dict(r, time=None) for r in snap["retraces"]["ring"]])
    return snap


def _drive(ledger, seed, fns):
    rng = np.random.default_rng(seed)
    for name, fn in fns.items():
        ledger.watch(name, fn)
    for step in range(60):
        op = rng.integers(0, 5)
        if op <= 1:
            ledger.note_transfer(f"site{rng.integers(0, 3)}",
                                 ("h2d", "d2h")[op],
                                 int(rng.integers(0, 1 << 20)),
                                 float(rng.choice([0.0, rng.random()])))
        elif op == 2:
            name = f"f{rng.integers(0, 2)}"
            ledger.observe_call(name, np.zeros((int(rng.integers(1, 4)), 2),
                                               np.float32), "static")
            fns[name].n += int(rng.integers(0, 2))
            ledger.poll_retraces()
        elif op == 3 and step == 30:
            ledger.mark_steady()
        elif op == 4 and step == 45:
            ledger.reset()
    return ledger.snapshot()


@pytest.mark.parametrize("seed", range(4))
def test_ledger_snapshots_equal_jax(seed):
    j = _drive(jtx.TransferLedger(), seed, {"f0": Cache(), "f1": Cache()})
    p = _drive(ptx.TransferLedger(registry=MetricsRegistry()), seed,
               {"f0": Cache(), "f1": Cache()})
    assert _untimed(p) == _untimed(j)


def test_site_gbs_steady_check_and_errors_equal_jax():
    out = []
    for mod, chk in ((jtx, jtx.TransferSteadyCheck),
                     (ptx, ptx.TransferSteadyCheck)):
        led = mod.TransferLedger()
        led.note_transfer("a", "h2d", 4_000_000, 0.002)
        led.note_transfer("b", "d2h", 10, 0.0)
        with pytest.raises(ValueError):
            led.note_transfer("a", "sideways", 1)
        with pytest.raises(ValueError):
            mod.TransferLedger(guard_mode="loud")
        c = Cache()
        led.watch("k", c)
        warm = chk(led)()
        led.mark_steady()
        c.n += 2
        after = chk(led)()
        out.append((led.site_gbs(), warm.status, after.status,
                    after.detail["retraces"], led.retrace_total,
                    led.watched(), mod.arg_signature(np.zeros((2, 3))),
                    mod.arg_signature("x" * 60)))
    assert out[0] == out[1]


def test_transferz_and_scopes_without_a_ledger(modes):
    ptx.set_transfers(None)
    assert ptx.transferz() == jtx.transferz()
    assert ptx.guard_scope("s") is ptx._NULL_CONTEXT
    assert ptx.allow_scope("s") is ptx._NULL_CONTEXT
    off = ptx.TransferLedger()
    assert off.guard("s") is ptx._NULL_CONTEXT
    assert off.allow("s") is ptx._NULL_CONTEXT
    assert modes == []


def test_log_scope_counts_a_sync_warning_at_its_site(modes):
    reg = MetricsRegistry()
    led = ptx.TransferLedger(guard_mode="log", registry=reg)
    ptx.set_transfers(led)
    with ptx.guard_scope("outer"):
        with ptx.guard_scope("inner"):
            warnings.warn(SYNC)
            warnings.warn(SYNC)
        warnings.warn(SYNC)
        with ptx.allow_scope("inner"):
            pass
    with warnings.catch_warnings(record=True) as other:
        warnings.simplefilter("always")
        warnings.warn("an unrelated warning")
    assert [str(w.message) for w in other] == ["an unrelated warning"]
    assert led.snapshot()["implicit_by_site"] == {"inner": 2, "outer": 1}
    assert reg.counter("implicit_transfers_total", site="inner").value == 2
    # enter, enter, exit inner, allow, allow closes, exit outer
    assert modes == [1, 1, 1, 0, 1, 0]
    assert ptx._SYNC._prev_show is None  # the warning hook is gone


def test_scopes_are_process_global_across_threads(modes):
    led = ptx.TransferLedger(guard_mode="log", registry=MetricsRegistry())
    ptx.set_transfers(led)
    entered, release = threading.Event(), threading.Event()

    def other():
        with led.guard("worker"):
            entered.set()
            release.wait(30)

    th = threading.Thread(target=other)
    th.start()
    assert entered.wait(30)
    warnings.warn(SYNC)  # this thread has no scope open
    with led.guard("main"):
        pass
    assert ptx._SYNC.armed == 1  # the worker's scope is still open
    release.set()
    th.join(30)
    assert not th.is_alive()
    assert led.snapshot()["implicit_by_site"] == {ptx.OTHER_THREAD: 1}
    assert modes[-1] == 0 and ptx._SYNC.armed == 0


def test_disallow_counts_and_reraises(modes):
    led = ptx.TransferLedger(guard_mode="disallow",
                             registry=MetricsRegistry())
    with pytest.raises(RuntimeError, match="synchronizing"):
        with led.guard("strict"):
            raise RuntimeError(SYNC)
    with pytest.raises(KeyError):
        with led.guard("strict"):
            raise KeyError("not a transfer")
    assert led.implicit_total == 1
    assert modes == [2, 0, 2, 0]


def test_library_watch_counts_reloads_after_steady(modes):
    led = ptx.TransferLedger(registry=MetricsRegistry())
    _build.load_library("fastblock")
    led.watch("fastblock", _build.LibraryWatch("fastblock"))
    led.mark_steady()
    lib = _build._loaded.pop("fastblock")
    try:
        _build.load_library("fastblock")
    finally:
        _build._loaded["fastblock"] = lib
    assert led.poll_retraces() == 1
    assert led.steady_state()["retraces"] == 1
    assert ptx.TransferSteadyCheck(led)().status == "degraded"


def test_enable_transfers_watches_the_libraries(modes):
    prev = (obs.get_registry(), obs.get_tracer())
    try:
        obs.enable()
        led = obs.enable_transfers(guard="log")
        assert obs.get_transfers() is led
        assert led.watched() == ["dsgd_sweep", "fastblock"]
        obs.disable()
        assert obs.get_transfers() is None and modes[-1] == 0
    finally:
        obs.set_registry(prev[0])
        obs.set_tracer(prev[1])
