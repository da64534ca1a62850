"""The port's event log (``streams/log.py``) against the JAX package's:
the same appends give byte-equal segment files and ``meta.json``; each
package reads, reopens, repairs and appends to the other's log; and the
port keeps the offset, roll, reopen, torn-tail, retention and below-floor
rules of ``tests/test_streams_log.py``."""

import os
import threading

import numpy as np
import pytest

from large_scale_recommendation_tpu.core.types import Ratings as JRatings
from large_scale_recommendation_tpu.streams import log as jlog
from large_scale_recommendation_tpu_torch.core.types import Ratings
from large_scale_recommendation_tpu_torch.streams.log import (
    HEADER_SIZE,
    RECORD_DTYPE,
    RECORD_SIZE,
    EventLog,
    LogTruncatedError,
)

PACKAGES = {"port": (EventLog, Ratings), "jax": (jlog.EventLog, JRatings)}


def _arrays(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 100, n), rng.integers(0, 50, n),
            rng.random(n).astype(np.float32))


def _batch(n, seed=0, pkg="port"):
    return PACKAGES[pkg][1].from_arrays(*_arrays(n, seed))


def _files(root):
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def test_header_and_record_format_are_the_jax_packages():
    assert RECORD_DTYPE == jlog.RECORD_DTYPE
    assert (RECORD_SIZE, HEADER_SIZE) == (jlog.RECORD_SIZE,
                                          jlog.HEADER_SIZE) == (12, 16)


def test_same_appends_give_byte_equal_files(tmp_path):
    logs = {name: cls(str(tmp_path / name), num_partitions=2,
                      segment_records=64, fsync=False)
            for name, (cls, _) in PACKAGES.items()}
    for name, log in logs.items():
        for k, (p, n) in enumerate([(0, 100), (1, 30), (0, 50), (1, 70)]):
            assert log.append(p, _batch(n, seed=k, pkg=name)) == \
                ((0, 100), (0, 30), (100, 150), (30, 100))[k]
        log.truncate_before(0, 70)
        log.close()
    port, jax_ = (_files(tmp_path / n) for n in ("port", "jax"))
    assert sorted(port) == sorted(jax_)
    assert "p0/seg_00000000000000000064.log" in port
    assert "p0/seg_00000000000000000000.log" not in port  # retired
    for f in port:
        assert port[f] == jax_[f], f


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_each_package_reads_and_extends_the_others_log(tmp_path, writer,
                                                       reader):
    w = PACKAGES[writer][0](str(tmp_path), num_partitions=2,
                            segment_records=16, fsync=False)
    users, items, vals = _arrays(40)
    w.append_arrays(1, users, items, vals)
    w.close()
    seg = tmp_path / "p1" / f"seg_{32:020d}.log"
    with open(seg, "ab") as f:  # a crashed writer's torn tail
        f.write(b"\x07" * 5)
    r = PACKAGES[reader][0](str(tmp_path), num_partitions=2,
                            segment_records=16, fsync=False)
    assert (r.start_offset(1), r.end_offset(1), r.end_offset(0)) == (0, 40, 0)
    out, nxt = r.read(1, 10, 100)
    assert nxt == 40
    np.testing.assert_array_equal(np.asarray(out.users), users[10:])
    np.testing.assert_array_equal(np.asarray(out.ratings), vals[10:])
    assert r.append(1, _batch(5, seed=1, pkg=reader)) == (40, 45)
    assert os.path.getsize(seg) == HEADER_SIZE + 13 * RECORD_SIZE
    r.truncate_before(1, 35)
    r.close()
    back = PACKAGES[writer][0](str(tmp_path), num_partitions=2,
                               segment_records=16, fsync=False)
    assert (back.start_offset(1), back.end_offset(1)) == (32, 45)
    with pytest.raises((LogTruncatedError, jlog.LogTruncatedError)):
        back.read(1, 0, 4)
    out, _ = back.read(1, 40, 10)
    np.testing.assert_array_equal(np.asarray(out.users),
                                  _arrays(5, seed=1)[0])


def test_roundtrip_offsets_and_padding(tmp_path):
    log = EventLog(str(tmp_path), fsync=False)
    b = _batch(100)
    assert log.append(0, b) == (0, 100)
    assert log.append(0, _batch(10, seed=1).pad_to(32)) == (100, 110)
    out, nxt = log.read(0, 90, 20)
    assert (nxt, out.n) == (110, 20)
    np.testing.assert_array_equal(out.users[:10], b.users[90:])
    out, nxt = log.read(0, 110, 100)  # at the end: empty
    assert (out.n, nxt) == (0, 110)


def test_partitions_have_independent_offsets(tmp_path):
    log = EventLog(str(tmp_path), num_partitions=3, fsync=False)
    assert log.append(1, _batch(10)) == (0, 10)
    assert log.append(2, _batch(20, seed=1)) == (0, 20)
    assert log.append(1, _batch(5, seed=2)) == (10, 15)
    assert log.end_offset(0) == 0
    assert log.lag({1: 10}) == 25
    with pytest.raises(IndexError):
        log.append(3, _batch(1))


def test_roll_reopen_and_geometry(tmp_path):
    log = EventLog(str(tmp_path), segment_records=64, fsync=False)
    b = _batch(300)
    log.append(0, b)
    assert [s[0] for s in log._parts[0].segments] == [0, 64, 128, 192, 256]
    out, nxt = log.read(0, 50, 200)  # spans 4 segments
    assert nxt == 250
    np.testing.assert_array_equal(out.users, b.users[50:250])
    log.close()
    # a smaller segment_records leaves the active segment over-full: the
    # next append seals it and rolls
    log2 = EventLog(str(tmp_path), segment_records=16, fsync=False)
    assert log2.append(0, _batch(20, seed=3)) == (300, 320)
    assert [tuple(s) for s in log2._parts[0].segments][-3:] == [
        (256, 44), (300, 16), (316, 4)]
    with pytest.raises(ValueError, match="renumber"):
        EventLog(str(tmp_path), num_partitions=2, fsync=False)


def test_torn_tail_and_headerless_shell(tmp_path):
    log = EventLog(str(tmp_path), segment_records=8, fsync=False)
    log.append(0, _batch(8))  # fills segment 0
    log.close()
    shell = tmp_path / "p0" / f"seg_{8:020d}.log"
    shell.write_bytes(b"LS")  # crash between create and header write
    log2 = EventLog(str(tmp_path), segment_records=8, fsync=False)
    assert log2.end_offset(0) == 8
    assert log2.append(0, _batch(3, seed=2)) == (8, 11)
    log2.close()
    with open(shell, "ab") as f:  # crash mid-append: 7 stray bytes
        f.write(b"\x01" * 7)
    log3 = EventLog(str(tmp_path), segment_records=8, fsync=False)
    assert log3.end_offset(0) == 11  # the unacked tail is not counted
    assert os.path.getsize(shell) == HEADER_SIZE + 3 * RECORD_SIZE + 7
    assert log3.append(0, _batch(2, seed=4)) == (11, 13)  # and is cut off
    assert os.path.getsize(shell) == HEADER_SIZE + 5 * RECORD_SIZE


def test_retention_and_the_floor(tmp_path):
    log = EventLog(str(tmp_path), segment_records=32, fsync=False)
    log.append(0, _batch(100))
    assert log.truncate_before(0, 70) == 64
    assert log.start_offset(0) == 64
    out, nxt = log.read(0, 64, 100)
    assert (out.n, nxt) == (36, 100)
    with pytest.raises(LogTruncatedError):
        log.read(0, 10, 5)
    log.truncate_before(0, 10 ** 9)  # beyond the end
    assert log.start_offset(0) == 96  # the active segment survives
    assert log.append(0, _batch(4, seed=1)) == (100, 104)


def test_reader_instance_sees_writes_and_retention(tmp_path):
    writer = EventLog(str(tmp_path), segment_records=16, fsync=False)
    writer.append(0, _batch(4))
    reader = EventLog(str(tmp_path), segment_records=16, fsync=False)
    writer.append(0, _batch(40, seed=1))  # grows the tail and rolls
    assert reader.end_offset(0) == 44 and reader.lag({0: 4}) == 40
    writer.truncate_before(0, 32)
    with pytest.raises(LogTruncatedError):  # not FileNotFoundError
        reader.read(0, 0, 8)
    assert reader.start_offset(0) == 32


def test_concurrent_tail_read_and_truncate(tmp_path):
    """The driver's race with ``truncate_log``: the consumer truncates on
    each checkpoint while the feeder reads the tail; reads return whole,
    correct data."""
    log = EventLog(str(tmp_path), segment_records=32, fsync=False)
    n = 4096
    idx = np.arange(n)
    log.append_arrays(0, idx % 997, idx % 991, idx.astype(np.float32))
    consumed, errors = [0], []

    def reader():
        try:
            off = 0
            while off < n:
                out, nxt = log.read(0, off, 100)
                np.testing.assert_array_equal(
                    out.ratings, np.arange(off, nxt, dtype=np.float32))
                off = consumed[0] = nxt
        except Exception as exc:  # surfaced below
            errors.append(exc)
            consumed[0] = n

    t = threading.Thread(target=reader)
    t.start()
    while consumed[0] < n:
        log.truncate_before(0, consumed[0])
    t.join(timeout=30)
    assert not t.is_alive() and not errors


def test_concurrent_append_and_tail_read(tmp_path):
    log = EventLog(str(tmp_path), segment_records=64, fsync=False)
    n, errors = 3000, []

    def writer():
        try:
            for k in range(0, n, 50):
                i = np.arange(k, k + 50)
                log.append_arrays(0, i % 997, i % 991, i.astype(np.float32))
        except Exception as exc:  # surfaced below
            errors.append(exc)

    t = threading.Thread(target=writer)
    t.start()
    off = 0
    while off < n and t.is_alive() or off < log.end_offset(0):
        out, nxt = log.read(0, off, 75)
        np.testing.assert_array_equal(out.ratings,
                                      np.arange(off, nxt, dtype=np.float32))
        off = nxt
    t.join(timeout=30)
    assert not t.is_alive() and not errors and off == n


@pytest.fixture
def journals():
    """An event journal in each package (the log reads it at
    construction); the previous ones restored after."""
    from large_scale_recommendation_tpu.obs import events as jev
    from large_scale_recommendation_tpu_torch.obs import events as pev

    prev = (jev.get_events(), pev.get_events())
    jev.set_events(jev.EventJournal())
    pev.set_events(pev.EventJournal())
    yield {"jax": jev.get_events(), "port": pev.get_events()}
    jev.set_events(prev[0])
    pev.set_events(prev[1])


def _rolls(journal, root):
    return [(os.path.relpath(e["detail"]["directory"], root),
             e["detail"]["sealed_base"], e["detail"]["new_base"])
            for e in journal.events("wal.segment_roll")]


def test_segment_rolls_are_journaled_as_in_jax(tmp_path, journals):
    """The same appends with small segments (and a reopen with smaller
    ones, whose over-full active segment rolls at once) journal the same
    ``wal.segment_roll`` events in both packages: one per roll."""
    for name, (cls, _) in PACKAGES.items():
        root = str(tmp_path / name)
        log = cls(root, num_partitions=2, segment_records=64, fsync=False)
        for k, (p, n) in enumerate([(0, 100), (1, 30), (0, 50), (1, 70)]):
            log.append(p, _batch(n, seed=k, pkg=name))
        log.close()
        log = cls(root, num_partitions=2, segment_records=16, fsync=False)
        log.append(0, _batch(20, seed=9, pkg=name))
        log.close()
    port, jax_ = (_rolls(journals[n], str(tmp_path / n))
                  for n in ("port", "jax"))
    assert port == jax_
    assert port == [("p0", 0, 64), ("p0", 64, 128), ("p1", 0, 64),
                    ("p0", 128, 150), ("p0", 150, 166)]
    segs = sorted(os.listdir(tmp_path / "port" / "p0"))
    assert len(segs) == 1 + sum(r[0] == "p0" for r in port)


def test_segment_roll_is_journaled_outside_the_partition_lock(tmp_path):
    """While the roll's event is emitted, another thread takes the
    partition's lock."""
    from large_scale_recommendation_tpu_torch.obs import events as pev

    seen = []

    class Journal:
        def emit(self, kind, **detail):
            got = []

            def take():
                got.append(part._lock.acquire(timeout=5.0))
                if got[0]:
                    part._lock.release()

            t = threading.Thread(target=take)
            t.start()
            t.join(10.0)
            assert not t.is_alive()
            seen.append((kind, got[0], detail["new_base"]))

    prev = pev.get_events()
    pev.set_events(Journal())
    try:
        log = EventLog(str(tmp_path / "l"), segment_records=8, fsync=False)
    finally:
        pev.set_events(prev)
    part = log._parts[0]
    log.append(0, _batch(20))
    log.close()
    assert seen == [("wal.segment_roll", True, 8),
                    ("wal.segment_roll", True, 16)]
