"""Partitioned append-only event log: the durable ingest tier's WAL
(counterpart of ``large_scale_recommendation_tpu.streams.log``; the files
are byte-compatible, so either package reads and appends to what the other
wrote).

- **fixed-size binary records** (``RECORD_DTYPE``: user int32, item int32,
  rating float32, 12 bytes) behind a 16-byte ``LSRTWAL1`` header per
  segment. A torn tail (``len % 12 != 0``) is ignored by opens and reads
  (it may be a live foreign producer's in-flight append) and truncated by
  the next append (the single-writer-per-partition contract says no other
  producer is alive then). Offsets are acked only after flush (and fsync
  with ``fsync=True``).
- **per-partition monotonic offsets**: record k of a partition lives in the
  segment whose base ≤ k, at byte ``HEADER + (k - base) * 12``; retention
  deletes whole segments from the front, and a read below the retained
  floor raises ``LogTruncatedError``.
- **fixed-size segment files** ``seg_<base20>.log``, rolled at
  ``segment_records``; ``truncate_before`` unlinks sealed segments wholly
  below an offset (the checkpointed consumed offset).

Delivery is at-least-once: consumers persist their consumed offset with
their state (``utils.checkpoint.save_online_state``) and replay the tail
from it after a crash. Pure host code: no tensor is touched here.

The causal plane binds at construction: with the tracer on, each acked
append is a ``wal/append`` span carrying its offset range and the record
trace id (``obs.disttrace.record_trace_id``), and an installed
``CriticalPathAnalyzer`` notes the append instant. Each partition's lock is
the contention plane's ``streams.wal_partition``. With an event journal
installed (``obs.events``), every segment roll emits ``wal.segment_roll``
(``directory``, ``sealed_base``, ``new_base``) after the partition's lock is
released: the journal's JSONL mirror may touch the disk.
"""

from __future__ import annotations

import json
import os
import re
import struct
import tempfile

import numpy as np

from large_scale_recommendation_tpu_torch.core.types import Ratings
from large_scale_recommendation_tpu_torch.obs.contention import named_rlock
from large_scale_recommendation_tpu_torch.obs.disttrace import (
    get_disttrace,
    record_trace_id,
)
from large_scale_recommendation_tpu_torch.obs.events import get_events
from large_scale_recommendation_tpu_torch.obs.trace import get_tracer

# one rating event; int32 ids + f32 value match Ratings' wire dtypes
RECORD_DTYPE = np.dtype([("user", "<i4"), ("item", "<i4"),
                         ("rating", "<f4")])
RECORD_SIZE = RECORD_DTYPE.itemsize  # 12

_MAGIC = b"LSRTWAL1"
_HEADER = struct.Struct("<8sII")  # magic, format version, record size
HEADER_SIZE = _HEADER.size
_SEG_FILE = re.compile(r"^seg_(\d{20})\.log$")


class LogTruncatedError(Exception):
    """A read landed below the retained floor: those records were
    retired by ``truncate_before`` and cannot be replayed."""


class _Partition:
    """One partition directory: sealed segments + the active tail."""

    def __init__(self, directory: str, segment_records: int, fsync: bool):
        self.directory = directory
        self.segment_records = segment_records
        self.fsync = fsync
        # the event journal, or None (one test per roll)
        self._events = get_events()
        os.makedirs(directory, exist_ok=True)
        # sealed: sorted [(base_offset, n_records)]; the LAST entry is
        # the active (appendable) segment
        self.segments: list[list[int]] = []
        self._fh = None  # append handle for the active segment
        # guards self.segments against the reader/truncator race: the
        # driver's consumer thread truncates on checkpoint while the
        # QueuedSource feeder thread reads the tail (re-entrant: _read
        # calls refresh); raw unless the contention plane is armed
        self._lock = named_rlock("streams.wal_partition")
        self._scan()

    # -- recovery-on-open ---------------------------------------------------

    def _scan(self) -> None:
        found = []
        for name in os.listdir(self.directory):
            m = _SEG_FILE.match(name)
            if m:
                found.append(int(m.group(1)))
        found.sort()
        for base in found:
            path = self._seg_path(base)
            size = os.path.getsize(path)
            if size < HEADER_SIZE:
                # crash between create and header flush: an empty shell
                # with no acked records
                payload = 0
            else:
                self._check_header(path)
                payload = size - HEADER_SIZE
            # count WHOLE records only; a trailing partial record is
            # either a crashed writer's torn tail (never acked) or a
            # LIVE producer's in-flight append from another process —
            # scanning cannot tell them apart, so it stays read-only
            # and any repair is deferred to the append path
            # (``_active_handle``), where the single-writer-per-
            # partition contract says no other producer is alive
            self.segments.append([base, payload // RECORD_SIZE])
        for (b0, n0), (b1, _) in zip(self.segments, self.segments[1:]):
            if b0 + n0 != b1:
                raise ValueError(
                    f"offset gap in {self.directory}: segment {b0} holds "
                    f"{n0} records but the next base is {b1}")
        if not self.segments:
            self._new_segment(0)

    def _check_header(self, path: str) -> None:
        with open(path, "rb") as f:
            magic, version, rsize = _HEADER.unpack(f.read(HEADER_SIZE))
        if magic != _MAGIC or version != 1 or rsize != RECORD_SIZE:
            raise ValueError(
                f"{path}: not a v1 event-log segment "
                f"(magic={magic!r}, version={version}, record={rsize})")

    # -- paths / state ------------------------------------------------------

    def _seg_path(self, base: int) -> str:
        return os.path.join(self.directory, f"seg_{base:020d}.log")

    def refresh(self) -> None:
        """Re-discover on-disk state written by OTHER EventLog instances
        (a producer in another process, the multi-process topology
        docs/STREAMING.md draws): re-stat the formerly-active tail, adopt
        newly rolled segments, drop front segments another process
        retired. Only whole records are trusted — a concurrent append's
        in-flight torn tail is not yet acked and is ignored — and a
        known count never shrinks (acked state is monotone)."""
        with self._lock:
            on_disk: dict[int, int] = {}
            for name in os.listdir(self.directory):
                m = _SEG_FILE.match(name)
                if m:
                    base = int(m.group(1))
                    size = os.path.getsize(
                        os.path.join(self.directory, name))
                    on_disk[base] = max(0, size - HEADER_SIZE) // RECORD_SIZE
            if not on_disk:
                return
            last_known = self.segments[-1][0]
            self.segments = [s for s in self.segments if s[0] in on_disk]
            if self.segments and self.segments[-1][0] == last_known:
                self.segments[-1][1] = max(self.segments[-1][1],
                                           on_disk[last_known])
            for base in sorted(on_disk):
                if base > last_known:
                    self.segments.append([base, on_disk[base]])
            if not self.segments:  # every known segment retired underneath
                self.segments = [[b, on_disk[b]] for b in sorted(on_disk)]
            for (b0, n0), (b1, _) in zip(self.segments, self.segments[1:]):
                if b0 + n0 != b1:
                    raise ValueError(
                        f"offset gap in {self.directory}: segment {b0} "
                        f"holds {n0} records but the next base is {b1}")

    @property
    def start_offset(self) -> int:
        with self._lock:
            return self.segments[0][0]

    @property
    def end_offset(self) -> int:
        with self._lock:
            base, n = self.segments[-1]
            return base + n

    def _new_segment(self, base: int) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        path = self._seg_path(base)
        with open(path, "xb") as f:
            f.write(_HEADER.pack(_MAGIC, 1, RECORD_SIZE))
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())
        self.segments.append([base, 0])

    def _active_handle(self):
        if self._fh is None:
            path = self._seg_path(self.segments[-1][0])
            size = os.path.getsize(path)
            if size < HEADER_SIZE:
                # crash between create and header flush (empty shell, no
                # acked records): rewrite the header. Done here — when
                # this instance claims the writer role — not at scan
                # time, so read-only opens never mutate a directory a
                # live foreign producer may be appending to.
                with open(path, "wb") as f:
                    f.write(_HEADER.pack(_MAGIC, 1, RECORD_SIZE))
                    f.flush()
                    if self.fsync:
                        os.fsync(f.fileno())
            else:
                torn = (size - HEADER_SIZE) % RECORD_SIZE
                if torn:
                    # a crashed writer's torn tail (never acked):
                    # truncate so our appends land on a record boundary
                    with open(path, "r+b") as f:
                        f.truncate(size - torn)
            self._fh = open(path, "ab")
        return self._fh

    # -- append -------------------------------------------------------------

    def append(self, records: np.ndarray) -> tuple[int, int]:
        """Append a RECORD_DTYPE array; returns the acked [start, end)
        offsets. The ack happens only after flush (+fsync when enabled),
        so an acked offset survives any crash after this returns."""
        start = self.end_offset
        pos = 0
        while pos < len(records):
            rolled = None
            with self._lock:
                base, n = self.segments[-1]
                room = self.segment_records - n
                if room <= 0:
                    # no room — including an active segment HOLDING MORE
                    # than segment_records (reopened with a smaller
                    # segment_records): treat it as sealed and roll
                    self._new_segment(base + n)
                    rolled = (int(base), int(base + n))
            if rolled is not None:
                if self._events is not None:  # outside the lock
                    self._events.emit("wal.segment_roll",
                                      directory=self.directory,
                                      sealed_base=rolled[0],
                                      new_base=rolled[1])
                continue
            take = min(room, len(records) - pos)
            fh = self._active_handle()
            fh.write(records[pos:pos + take].tobytes())
            fh.flush()
            if self.fsync:
                os.fsync(fh.fileno())
            with self._lock:
                # assign, don't increment: a concurrent reader's
                # refresh() may already have max-bumped the count from
                # the flushed file size — incrementing on top of that
                # double-counts and inflates the count past the file.
                # Single writer per partition, so n + take is exact.
                self.segments[-1][1] = n + take
            pos += take
        return start, self.end_offset

    # -- read ---------------------------------------------------------------

    def read(self, start: int, max_records: int) -> tuple[np.ndarray, int]:
        """Up to ``max_records`` from offset ``start``; returns
        ``(records, next_offset)``. Reading at/after the end returns an
        empty batch; reading below the retained floor raises. A read
        outside the known range first ``refresh``es from disk, so a
        tailer instance observes another process's appends (and its
        retention); a segment deleted underneath a known range (foreign
        retention) triggers one refresh+retry, so it surfaces as
        ``LogTruncatedError``, never a raw ``FileNotFoundError`` (or a
        short read from a foreign process's concurrent retention)."""
        try:
            return self._read(start, max_records)
        except OSError:  # includes FileNotFoundError and short reads
            self.refresh()
            return self._read(start, max_records)

    def _read(self, start: int, max_records: int) -> tuple[np.ndarray, int]:
        # the whole read is under the partition lock: truncate_before /
        # refresh cannot reshape self.segments mid-iteration, so the
        # output buffer is either filled completely or the read raises —
        # never returned with uninitialized np.empty rows
        with self._lock:
            if start >= self.end_offset or start < self.start_offset:
                self.refresh()
            if start < self.start_offset:
                raise LogTruncatedError(
                    f"offset {start} is below the retained floor "
                    f"{self.start_offset} of {self.directory} — those "
                    "records were retired by truncate_before and cannot "
                    "be replayed")
            end = min(start + max_records, self.end_offset)
            if end <= start:
                return np.empty(0, RECORD_DTYPE), start
            out = np.empty(end - start, RECORD_DTYPE)
            filled = 0
            for base, n in self.segments:
                lo, hi = max(base, start), min(base + n, end)
                if lo >= hi:
                    continue
                with open(self._seg_path(base), "rb") as f:
                    f.seek(HEADER_SIZE + (lo - base) * RECORD_SIZE)
                    buf = f.read((hi - lo) * RECORD_SIZE)
                if len(buf) != (hi - lo) * RECORD_SIZE:
                    raise OSError(
                        f"short read in {self._seg_path(base)}: wanted "
                        f"records [{lo}, {hi}) but the segment holds less")
                out[filled:filled + hi - lo] = np.frombuffer(buf,
                                                             RECORD_DTYPE)
                filled += hi - lo
            if filled != end - start:
                raise OSError(
                    f"segment gap reading [{start}, {end}) in "
                    f"{self.directory}: only {filled} of {end - start} "
                    "records found")
            return out, end

    # -- retention ----------------------------------------------------------

    def truncate_before(self, offset: int) -> int:
        """Delete sealed segments whose every record is < ``offset``
        (the active segment always survives). Returns the new floor."""
        with self._lock:
            while len(self.segments) > 1:
                base, n = self.segments[0]
                if base + n > offset:
                    break
                os.unlink(self._seg_path(base))
                self.segments.pop(0)
            return self.start_offset

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class EventLog:
    """A directory of ``p<k>/`` partitions of fixed-size segments.

    ``meta.json`` pins (num_partitions, segment_records, record format)
    at create time; reopening with different geometry raises instead of
    silently renumbering offsets. Writes are single-writer per partition
    (the topology here: one producer per partition, exactly the
    reference's partitioned-source shape). Readers — same instance,
    another instance, or another process — are safe: reads open their
    own handles, trust only whole (acked) records, and a read outside
    the instance's known range re-discovers the on-disk state
    (``_Partition.refresh``), so a tailer observes a separate producer
    process's appends instead of freezing at its open-time end.
    """

    def __init__(self, directory: str, num_partitions: int = 1,
                 segment_records: int = 1 << 16, fsync: bool = True):
        if num_partitions < 1:
            raise ValueError(f"num_partitions must be ≥ 1, "
                             f"got {num_partitions}")
        if segment_records < 1:
            raise ValueError(f"segment_records must be ≥ 1, "
                             f"got {segment_records}")
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        meta_path = os.path.join(directory, "meta.json")
        meta = {"format": 1, "num_partitions": num_partitions,
                "segment_records": segment_records,
                "record_size": RECORD_SIZE}
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                on_disk = json.load(f)
            if (on_disk.get("num_partitions") != num_partitions
                    or on_disk.get("record_size") != RECORD_SIZE):
                raise ValueError(
                    f"{directory} was created with "
                    f"{on_disk.get('num_partitions')} partitions / "
                    f"{on_disk.get('record_size')}-byte records; reopening "
                    f"with {num_partitions}/{RECORD_SIZE} would renumber "
                    "offsets")
            # segment_records may differ across opens: it only shapes
            # NEW segments, existing offset math is unaffected
        else:
            fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(meta, f)
                os.replace(tmp, meta_path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        self.num_partitions = num_partitions
        self._parts = [
            _Partition(os.path.join(directory, f"p{k}"),
                       segment_records, fsync)
            for k in range(num_partitions)
        ]
        self._trace = get_tracer()
        self._disttrace = get_disttrace()

    # -- append -------------------------------------------------------------

    def _part(self, partition: int) -> _Partition:
        if not 0 <= partition < self.num_partitions:
            raise IndexError(f"partition {partition} not in "
                             f"[0, {self.num_partitions})")
        return self._parts[partition]

    def append_arrays(self, partition: int, users, items,
                      ratings) -> tuple[int, int]:
        """Append raw triples; returns the acked [start, end) offsets.
        With the tracer on the durable write is a ``wal/append`` span
        carrying the acked range and the record trace id; an installed
        critical-path analyzer notes the append instant."""
        users = np.asarray(users)
        records = np.empty(len(users), RECORD_DTYPE)
        records["user"] = users.astype(np.int32)
        records["item"] = np.asarray(items, dtype=np.int32)
        records["rating"] = np.asarray(ratings, dtype=np.float32)
        if self._trace.enabled:
            with self._trace.span("wal/append", partition=int(partition),
                                  n=int(len(users))) as sp:
                start, end = self._part(partition).append(records)
                # stamped before exit so they export with the span
                sp.args["start_offset"] = int(start)
                sp.args["end_offset"] = int(end)
                sp.args["trace_id"] = record_trace_id(partition, start)
        else:
            start, end = self._part(partition).append(records)
        if self._disttrace is not None:
            self._disttrace.note_append(end, partition=partition)
        return start, end

    def append(self, partition: int, batch: Ratings) -> tuple[int, int]:
        """Append a ``Ratings`` batch. Weight-0 entries are padding by
        the ``Ratings`` contract, not data — they are dropped, so log
        offsets count real ratings only."""
        ru, ri, rv, rw = batch.to_numpy()
        real = rw > 0
        return self.append_arrays(partition, ru[real], ri[real], rv[real])

    # -- read ---------------------------------------------------------------

    def read(self, partition: int, start: int,
             max_records: int) -> tuple[Ratings, int]:
        """Up to ``max_records`` starting at ``start``; returns
        ``(Ratings, next_offset)`` (empty batch at end-of-log)."""
        records, nxt = self._part(partition).read(start, max_records)
        return Ratings.from_arrays(records["user"], records["item"],
                                   records["rating"]), nxt

    def start_offset(self, partition: int = 0) -> int:
        """First replayable offset (retention floor), refreshed from
        disk so another process's retention is visible."""
        part = self._part(partition)
        part.refresh()
        return part.start_offset

    def end_offset(self, partition: int = 0) -> int:
        """The next offset an append would receive (= records ever
        appended, while the floor is 0), refreshed from disk so another
        process's appends are visible."""
        part = self._part(partition)
        part.refresh()
        return part.end_offset

    def lag(self, offsets: dict[int, int]) -> int:
        """Total records appended but not yet consumed, given a
        ``{partition: consumed_offset}`` map (missing partitions count
        from their floor) — the lag-in-records telemetry the driver
        surfaces. Refreshed from disk: lag against the TRUE log head,
        not this instance's last sighting of it."""
        total = 0
        for k in range(self.num_partitions):
            self._parts[k].refresh()
            consumed = offsets.get(k, self._parts[k].start_offset)
            total += max(0, self._parts[k].end_offset - consumed)
        return total

    # -- retention ----------------------------------------------------------

    def truncate_before(self, partition: int, offset: int) -> int:
        """Retire whole segments below ``offset`` (typically the
        checkpointed consumed offset — never truncate past it, or the
        post-crash replay in ``StreamingDriver.resume`` has nothing to
        read). Returns the new retained floor."""
        return self._part(partition).truncate_before(offset)

    def close(self) -> None:
        for p in self._parts:
            p.close()

    def __enter__(self) -> "EventLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
