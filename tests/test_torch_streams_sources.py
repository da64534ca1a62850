"""The port's sources and ingest queue (``streams/sources.py``) against
the JAX package's: the same puts and gets under each overflow policy give
the same accept/shed decisions and the same ``IngestStats`` snapshot;
``split_poison`` and the dead-letter buffer give the same arrays; the
log-tail, generator and CSV sources stamp the same offsets; a feeder fault
is re-raised by ``finish()``."""

import threading

import numpy as np
import pytest

from large_scale_recommendation_tpu.core.generators import (
    SyntheticMFGenerator as JGenerator,
)
from large_scale_recommendation_tpu.core.types import Ratings as JRatings
from large_scale_recommendation_tpu.streams import log as jlog
from large_scale_recommendation_tpu.streams import sources as jsrc
from large_scale_recommendation_tpu_torch.core.generators import (
    SyntheticMFGenerator,
)
from large_scale_recommendation_tpu_torch.core.types import Ratings
from large_scale_recommendation_tpu_torch.streams import sources as src
from large_scale_recommendation_tpu_torch.streams.log import (
    EventLog,
    LogTruncatedError,
)

PKGS = {"port": (src, Ratings), "jax": (jsrc, JRatings)}


def _sbatch(pkg, n, start=0, seed=0, pad_to=None):
    mod, R = PKGS[pkg]
    rng = np.random.default_rng(seed)
    r = R.from_arrays(rng.integers(0, 40, n), rng.integers(0, 30, n),
                      rng.random(n).astype(np.float32))
    if pad_to:
        r = r.pad_to(pad_to)
    return mod.StreamBatch(ratings=r, partition=0, start_offset=start,
                           end_offset=start + n)


def _script(pkg, policy):
    """Four puts into a capacity-2 queue (one padded), a get, two more puts
    (the second with a timeout), close, drain."""
    q = PKGS[pkg][0].IngestQueue(capacity=2, policy=policy)
    acks = [q.put(_sbatch(pkg, 10, start=0)),
            q.put(_sbatch(pkg, 7, start=10, seed=1)),
            q.put(_sbatch(pkg, 6, start=17, seed=2, pad_to=16)),
            q.put(_sbatch(pkg, 5, start=23, seed=3))]
    got = [q.get().start_offset]
    acks += [q.put(_sbatch(pkg, 4, start=28, seed=4)),
             q.put(_sbatch(pkg, 3, start=32, seed=5), timeout=0.01)]
    q.close()
    while (b := q.get()) is not None:
        got.append(b.start_offset)
    acks.append(q.put(_sbatch(pkg, 1, start=40)))  # closed
    return acks, got, q.stats.snapshot(), q.dead_letters.records()


@pytest.mark.parametrize("policy", ["block", "drop", "dead_letter"])
def test_queue_policies_match_jax(policy):
    if policy == "block":  # the over-capacity puts would block forever
        acks, got, stats, dead = _script_block()
    else:
        acks, got, stats, dead = _script("port", policy)
        jacks, jgot, jstats, jdead = _script("jax", policy)
        assert (acks, got, stats) == (jacks, jgot, jstats)
        for a, b in zip(dead, jdead):
            np.testing.assert_array_equal(a, b)
    assert got[0] == 0 and acks[-1] is False
    if policy == "drop":
        assert stats["dropped_batches"] == 3
        assert stats["dropped_records"] == 6 + 5 + 3  # real rows, not spans
    if policy == "dead_letter":
        assert stats["dead_letter_records"] == 14 and len(dead[0]) == 14


def _script_block():
    out = []
    for pkg in ("port", "jax"):
        q = PKGS[pkg][0].IngestQueue(capacity=2, policy="block")
        acks = [q.put(_sbatch(pkg, 10)), q.put(_sbatch(pkg, 7, 10, 1)),
                q.put(_sbatch(pkg, 5, 17, 2), timeout=0.01)]  # times out
        got = [q.get().start_offset]
        acks.append(q.put(_sbatch(pkg, 4, 17, 3)))
        q.close()
        while (b := q.get()) is not None:
            got.append(b.start_offset)
        acks.append(q.put(_sbatch(pkg, 1, 21)))
        out.append((acks, got, q.stats.snapshot(), q.dead_letters.records()))
    assert out[0][:3] == out[1][:3]
    assert out[0][0] == [True, True, False, True, False]
    assert out[0][2]["blocked_puts"] == 1 and out[0][1] == [0, 10, 17]
    return out[0]


def test_block_policy_loses_nothing_across_threads():
    q = src.IngestQueue(capacity=2, policy="block")
    n = 40

    def producer():
        for k in range(n):
            q.put(_sbatch("port", 5, start=k * 5))
        q.close()

    t = threading.Thread(target=producer)
    t.start()
    consumed = []
    while (b := q.get(timeout=30)) is not None:
        consumed.append(b.start_offset)
    t.join(timeout=30)
    assert not t.is_alive()
    assert consumed == [k * 5 for k in range(n)]
    assert q.stats.depth_high_water <= 2
    with pytest.raises(ValueError, match="policy"):
        src.IngestQueue(policy="explode")


def test_split_poison_and_dead_letter_buffer_match_jax():
    rng = np.random.default_rng(3)
    users = rng.integers(-2, 9, 200)
    items = rng.integers(-1, 9, 200)
    vals = rng.random(200).astype(np.float32)
    vals[rng.integers(0, 200, 20)] = np.nan
    vals[5] = np.inf
    np.testing.assert_array_equal(src.split_poison(users, items, vals),
                                  jsrc.split_poison(users, items, vals))
    bufs = [src.DeadLetterBuffer(capacity=100),
            jsrc.DeadLetterBuffer(capacity=100)]
    for buf in bufs:
        for lo, hi in ((0, 30), (30, 90), (90, 200)):  # the last oversized
            buf.put(users[lo:hi], items[lo:hi], vals[lo:hi])
    assert [len(b) for b in bufs] == [100, 100]
    assert [b.total for b in bufs] == [200, 200]
    for a, b in zip(bufs[0].records(), bufs[1].records()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(bufs[0].records()[0], users[100:])


def test_sources_stamp_the_jax_offsets(tmp_path):
    stamps = {}
    for pkg, Log, Gen in (("port", EventLog, SyntheticMFGenerator),
                          ("jax", jlog.EventLog, JGenerator)):
        mod = PKGS[pkg][0]
        log = Log(str(tmp_path / pkg), fsync=False)
        gen = Gen(num_users=30, num_items=20, rank=3, seed=1)
        assert mod.pump_to_log(mod.GeneratorSource(gen, 128, num_batches=3),
                               log) == 384
        tail = list(mod.LogTailSource(log, batch_records=150))
        resumed = list(mod.LogTailSource(log, start_offset=300,
                                         batch_records=150))
        stamps[pkg] = ([(b.start_offset, b.end_offset) for b in tail],
                       [(b.start_offset, b.end_offset) for b in resumed],
                       np.concatenate([b.ratings.users for b in tail]))
    assert stamps["port"][:2] == stamps["jax"][:2] == (
        [(0, 150), (150, 300), (300, 384)], [(300, 384)])
    np.testing.assert_array_equal(stamps["port"][2], stamps["jax"][2])
    path = tmp_path / "u.data"
    path.write_text("".join(f"{u}\t{u % 7}\t{u % 5 + 1}.0\t0\n"
                            for u in range(25)))
    csv = [(b.start_offset, b.end_offset)
           for b in src.CSVSource(str(path), batch_records=10)]
    jcsv = [(b.start_offset, b.end_offset)
            for b in jsrc.CSVSource(str(path), batch_records=10)]
    assert csv == jcsv == [(0, 10), (10, 20), (20, 25)]


def test_log_tail_follow_sees_late_appends(tmp_path):
    log = EventLog(str(tmp_path), fsync=False)
    log.append_arrays(0, [1], [2], [3.0])
    tail = src.LogTailSource(log, batch_records=10, follow=True,
                             poll_interval_s=0.001)
    got, first = [], threading.Event()
    second = threading.Event()

    def consume():
        for b in tail:
            got.append(b.end_offset)
            (second if first.is_set() else first).set()

    t = threading.Thread(target=consume)
    t.start()
    assert first.wait(30)
    log.append_arrays(0, [4], [5], [6.0])  # lands after the tail caught up
    assert second.wait(30)
    tail.stop()
    t.join(timeout=30)
    assert not t.is_alive() and got == [1, 2]


def test_quarantine_keeps_offsets_and_feeds_clean_rows():
    bad = src.StreamBatch(
        ratings=Ratings.from_arrays([1, -1, 2, 3], [1, 2, 3, 4],
                                    np.array([1, 1, np.nan, 1], np.float32)),
        partition=0, start_offset=100, end_offset=104)
    qs = src.QueuedSource([bad])
    out = list(qs)
    assert [(b.start_offset, b.end_offset) for b in out] == [(100, 104)]
    np.testing.assert_array_equal(out[0].ratings.users, [1, 3])
    assert qs.stats.poison_records == 2
    assert sorted(qs.dead_letters.records()[0].tolist()) == [-1, 2]


def test_feeder_fault_is_reraised_by_finish(tmp_path):
    def faulty():
        yield _sbatch("port", 10, start=0)
        yield _sbatch("port", 10, start=10)
        raise RuntimeError("boom")

    qs = src.QueuedSource(faulty(), capacity=4)
    it = qs.batches()
    assert next(it).start_offset == 0
    qs._thread.join(timeout=30)  # the feeder runs into its fault
    assert not qs._thread.is_alive()
    with pytest.raises(RuntimeError, match="boom"):
        qs.finish()
    # a runtime fault of the log tail surfaces on the consumer side too
    log = EventLog(str(tmp_path), segment_records=16, fsync=False)
    log.append_arrays(0, np.arange(64) % 9, np.arange(64) % 7,
                      np.ones(64, np.float32))
    log.truncate_before(0, 48)
    with pytest.raises(LogTruncatedError):
        list(src.QueuedSource(src.LogTailSource(log, start_offset=0,
                                                batch_records=16)))
