"""The port's PS-hosted online + batch MF (``ps.adaptive``) against the JAX
package's, on the CPU, from the same seeded numpy inputs.

Like for like: the workers and shards of each package are driven by the
same one-thread loop (``drive``: pushes and controls reach their shards
at once, pulls are answered in FIFO order, at most ``lag`` of them left
in flight after each event), so both packages see one message order and
every state transition happens at the same event. (``PSOnlineBatchMF.run``
runs the same logics on threads, where the order of answers follows thread
timing even at one worker.) Bars:
- online only, both modes: host numpy in both packages (``delta_np``, the
  chunked minibatch-mean update, ``np.add.at``): bit-equal;
- with a mid-stream ``BATCH_TRIGGER``: the replay runs ``online_train``
  (XLA against torch sums), so user and item factors within rtol 1e-4 /
  atol 1e-5 and the online emissions likewise.
Both packages' PS modules build their initializers through one patched
name, a ``FunctionFactorInitializer`` over one seeded numpy table.

The same loop runs 4 workers and 3 shards in round robin for the JAX
test's chunked-vs-per-rating quality bar on fixed message orders. Then
the state machines (BatchInit discard, the unstarted worker's push
ignored, the early finish, the protocol violations, the double trigger)
and the threaded driver at the JAX tests' other quality bars
(``tests/test_ps_adaptive.py``) on the JAX tests' inputs (``jax_rows``:
the JAX package's initial rows), each run with a 30 s idle window.
"""

import collections

import numpy as np
import pytest
import torch

from large_scale_recommendation_tpu.ps import adaptive as jad
from large_scale_recommendation_tpu.ps.core import PullAnswer as JPullAnswer
from large_scale_recommendation_tpu_torch.core.generators import (
    SyntheticMFGenerator,
)
from large_scale_recommendation_tpu_torch.core.initializers import (
    PseudoRandomFactorInitializer,
)
from large_scale_recommendation_tpu_torch.ps import adaptive as pad
from large_scale_recommendation_tpu_torch.ps.adaptive import (
    BATCH_TRIGGER,
    AdaptivePSLogic,
    OnlineBatchWorkerLogic,
    PSOnlineBatchConfig,
    PSOnlineBatchMF,
)
from large_scale_recommendation_tpu_torch.ps.core import PullAnswer
from large_scale_recommendation_tpu_torch.ps.server import (
    ShardedParameterStore,
)
from large_scale_recommendation_tpu_torch.ps.transform import ps_transform
from test_torch_ps import TOL, WAIT, jax_rows, patch_ps, table_inits

RANK = 4


def planted(n=6000, seed=0):
    gen = SyntheticMFGenerator(num_users=60, num_items=40, rank=4,
                               noise=0.05, seed=seed)
    return gen.generate(n), gen.generate(1500)


def events(ratings, trigger_at=()):
    ru, ri, rv, _ = ratings.to_numpy()
    marks = set(trigger_at)
    out = []
    for j in range(len(ru)):
        if j in marks:
            out.append(BATCH_TRIGGER)
        out.append((int(ru[j]), int(ri[j]), float(rv[j])))
    return out


class SyncClient:
    """Worker ``w``'s client in a one-thread topology: pushes and controls
    reach their shards at once (by ``abs(id) % P``), pulls wait in the
    FIFO all workers share."""

    def __init__(self, w, shards, fifo):
        self.w, self.shards, self.fifo = w, shards, fifo
        self.rid = 0
        self.outputs: list = []
        self.ps_outputs: list = []

    def pull(self, ids):
        self.fifo.append((self, self.rid, np.asarray(ids, np.int64)))
        self.rid += 1

    def push(self, ids, deltas):
        ids = np.asarray(ids, np.int64)
        deltas = np.asarray(deltas, np.float32)
        shard = np.abs(ids) % len(self.shards)
        for p in np.unique(shard):
            m = shard == p
            self.shards[p].on_push(ids[m], deltas[m], self.ps_outputs,
                                   worker_id=self.w)

    def control(self, shard_id, payload):
        self.shards[shard_id].on_control(self.w, payload, self.ps_outputs)

    def output(self, value):
        self.outputs.append(value)


def drive(workers, shards, inputs, answer_cls, trigger, lag=2):
    """Feed each worker its ``inputs`` in round robin (``trigger`` stands
    for the package's sentinel), answering pulls in FIFO order and leaving
    at most ``lag`` in flight after each event; drain at input end. One
    message order, whatever the threads of a real topology would do."""
    fifo = collections.deque()
    clients = [SyncClient(w, shards, fifo) for w in range(len(workers))]

    def pump(keep):
        while len(fifo) > keep:
            client, rid, ids = fifo.popleft()
            shard = np.abs(ids) % len(shards)
            parts = {p: shards[p].on_pull(ids[shard == p])
                     for p in np.unique(shard)}
            values = np.empty((len(ids), next(iter(parts.values())).shape[1]),
                              np.float32)
            for p, v in parts.items():
                values[shard == p] = v
            workers[client.w].on_pull_answer(
                answer_cls(ids, values, request_id=rid), client)

    streams = [iter(x) for x in inputs]
    live = list(range(len(workers)))
    while live:
        for w in list(live):
            ev = next(streams[w], None)
            if ev is None:
                live.remove(w)
                workers[w].on_input_end(clients[w])
            else:
                workers[w].on_recv(trigger if ev is BATCH_TRIGGER else ev,
                                   clients[w])
            pump(lag)
    pump(0)
    for w, worker in enumerate(workers):
        worker.close(clients[w])
    return clients


def routed(evs, workers):
    inputs = [[] for _ in range(workers)]
    for ev in evs:
        if ev is BATCH_TRIGGER:
            for w in inputs:
                w.append(ev)
        else:
            inputs[int(ev[0]) % workers].append(ev)
    return inputs


def run_both(monkeypatch, cfg_kw, evs, lag=2):
    """Both packages' worker and shard logics through ``drive``: per
    package (workers, shards, clients)."""
    patch_ps(monkeypatch, [jad], [pad], rank=RANK)
    jinit, pinit = table_inits(RANK)
    W, P = cfg_kw["worker_parallelism"], cfg_kw["ps_parallelism"]
    jcfg = jad.PSOnlineBatchConfig(**cfg_kw)
    pcfg = PSOnlineBatchConfig(**cfg_kw)
    jws = [jad.OnlineBatchWorkerLogic(jcfg, w) for w in range(W)]
    jshs = [jad.AdaptivePSLogic(jinit(RANK), W) for _ in range(P)]
    pws = [OnlineBatchWorkerLogic(pcfg, w, device="cpu") for w in range(W)]
    pshs = [AdaptivePSLogic(pinit(RANK), W) for _ in range(P)]
    inputs = routed(evs, W)
    jc = drive(jws, jshs, inputs, JPullAnswer, jad.BATCH_TRIGGER, lag)
    pc = drive(pws, pshs, inputs, PullAnswer, BATCH_TRIGGER, lag)
    return (jws, jshs, jc), (pws, pshs, pc)


def stack(d):
    keys = sorted(d)
    return keys, np.stack([np.asarray(d[k]) for k in keys])


def assert_same_run(j, p, exact):
    close = (np.testing.assert_array_equal if exact else
             lambda a, b: np.testing.assert_allclose(a, b, **TOL))
    for jw, pw in zip(j[0], p[0]):
        assert pw.batches_run == jw.batches_run and pw.state == jw.state
        assert pw.history == jw.history
        ka, va = stack(pw.users)
        kb, vb = stack(jw.users)
        assert ka == kb
        close(va, vb)
    for jsh, psh in zip(j[1], p[1]):
        assert psh.state == jsh.state
        assert psh.batches_seen == jsh.batches_seen
        ka, va = stack(psh.snapshot())
        kb, vb = stack(jsh.snapshot())
        assert ka == kb
        close(va, vb)
    for jc, pc in zip(j[2], p[2]):
        for a, b in ((pc.outputs, jc.outputs),
                     (pc.ps_outputs, jc.ps_outputs)):
            assert [x[0] for x in a] == [x[0] for x in b]
            if a:
                close(np.stack([x[1] for x in a]),
                      np.stack([np.asarray(x[1]) for x in b]))


BASE = dict(num_factors=RANK, iterations=3, learning_rate=0.1,
            lr_schedule="inverse_sqrt", worker_parallelism=1,
            ps_parallelism=1, pull_limit=2, pull_limit_online=4,
            chunk_size=8, minibatch_size=32, seed=0, online_chunk_size=16)


@pytest.mark.parametrize("mode", ["per_rating", "chunked"])
def test_online_only_bit_equal_to_jax(monkeypatch, mode):
    train, _ = planted(n=1200)
    j, p = run_both(monkeypatch, dict(BASE, online_mode=mode),
                    events(train))
    assert p[0][0].batches_run == 0
    assert_same_run(j, p, exact=True)


@pytest.mark.parametrize("mode", ["per_rating", "chunked"])
@pytest.mark.parametrize("lag", [0, 3])
def test_midstream_trigger_matches_jax(monkeypatch, mode, lag):
    """``lag`` 3 leaves online pulls in flight at the trigger: BatchInit
    discards their answers in both packages."""
    train, _ = planted(n=1500)
    j, p = run_both(monkeypatch, dict(BASE, online_mode=mode),
                    events(train, trigger_at=[900]), lag=lag)
    assert p[0][0].batches_run == 1
    assert len(p[0][0].history) == train.n
    assert_same_run(j, p, exact=False)


def test_two_triggers_match_jax(monkeypatch):
    train, _ = planted(n=1500)
    j, p = run_both(monkeypatch, dict(BASE, online_mode="chunked"),
                    events(train, trigger_at=[500, 1100]), lag=0)
    assert p[0][0].batches_run == 2
    assert_same_run(j, p, exact=False)


# -- server state machine ---------------------------------------------------


def shard_logic():
    return AdaptivePSLogic(PseudoRandomFactorInitializer(4, scale=0.1),
                           worker_parallelism=2)


def test_param_clear_retrain_from_scratch():
    logic, out = shard_logic(), []
    logic.on_push(np.asarray([7]), np.ones((1, 4), np.float32), out)
    assert 7 in logic.snapshot() and out[0][0] == 7
    logic.on_control(0, "batch_start", out)
    assert logic.state == "batch_init"
    assert logic.snapshot() == {}  # cleared
    logic.on_control(1, "batch_start", out)
    assert logic.state == "batch"
    logic.on_control(0, "batch_end", out)
    logic.on_control(1, "batch_end", out)
    assert logic.state == "online"
    assert logic.batches_seen == 1


def test_server_ignores_push_from_unstarted_worker_in_batch_init():
    logic, out = shard_logic(), []
    logic.on_control(0, "batch_start", out)
    logic.on_push(np.asarray([5]), np.ones((1, 4), np.float32), out,
                  worker_id=1)  # worker 1 has not signed: ignored
    assert 5 not in logic.snapshot()
    logic.on_push(np.asarray([5]), np.ones((1, 4), np.float32), out,
                  worker_id=0)
    assert 5 in logic.snapshot()
    assert out == []  # no online emissions outside Online


def test_early_finish_before_all_started_is_tolerated():
    logic, out = shard_logic(), []
    logic.on_control(0, "batch_start", out)
    logic.on_control(0, "batch_end", out)
    assert logic.state == "batch_init"
    logic.on_control(1, "batch_start", out)
    assert logic.state == "batch"
    logic.on_control(1, "batch_end", out)
    assert logic.state == "online"
    assert logic.batches_seen == 1


def test_protocol_violations_raise():
    logic, out = shard_logic(), []
    logic.on_control(0, "batch_start", out)
    with pytest.raises(RuntimeError, match="duplicate batch-start"):
        logic.on_control(0, "batch_start", out)
    with pytest.raises(RuntimeError, match="never signed"):
        logic.on_control(1, "batch_end", out)
    logic.on_control(0, "batch_end", out)
    with pytest.raises(RuntimeError, match="duplicate batch-end"):
        logic.on_control(0, "batch_end", out)
    with pytest.raises(ValueError, match="unknown control"):
        logic.on_control(0, "bogus", out)


def test_double_trigger_raises():
    logic = OnlineBatchWorkerLogic(
        PSOnlineBatchConfig(num_factors=4, worker_parallelism=1,
                            ps_parallelism=1), 0, device="cpu")

    class NullClient:
        def pull(self, ids): pass
        def push(self, ids, deltas): pass
        def control(self, shard, payload): pass
        def output(self, value): pass

    ps = NullClient()
    logic.on_recv((1, 2, 3.0), ps)
    logic.on_recv(BATCH_TRIGGER, ps)
    # the online pull is outstanding → still BatchInit
    assert logic.state == "batch_init"
    with pytest.raises(RuntimeError, match="not finished"):
        logic.on_recv(BATCH_TRIGGER, ps)


def test_batch_init_discards_in_flight_answers(monkeypatch):
    """An answer to an online pull issued before the trigger is thrown
    away in BatchInit; the replay starts once the window drains."""
    patch_ps(monkeypatch, [], [pad], rank=RANK)
    cfg = PSOnlineBatchConfig(**dict(BASE, online_mode="per_rating"))
    w = OnlineBatchWorkerLogic(cfg, 0, device="cpu")
    shard = AdaptivePSLogic(table_inits(RANK)[1](RANK), 1)
    fifo = collections.deque()
    client = SyncClient(0, [shard], fifo)
    for ev in ((1, 2, 3.0), (4, 5, 1.0)):
        w.on_recv(ev, client)
    assert len(fifo) == 2
    w.on_recv(BATCH_TRIGGER, client)
    assert w.state == "batch_init" and shard.state == "batch"
    _, rid, ids = fifo.popleft()
    w.on_pull_answer(PullAnswer(ids, shard.on_pull(ids), request_id=rid),
                     client)
    assert w.state == "batch_init"
    assert w.users == {}  # discarded, not applied
    _, rid, ids = fifo.popleft()
    w.on_pull_answer(PullAnswer(ids, shard.on_pull(ids), request_id=rid),
                     client)
    assert w.state == "batch"  # drained: the replay's pulls went out
    assert fifo


# -- the threaded driver: the JAX tests' quality bars -------------------------


def test_midstream_trigger_retrains_and_converges(monkeypatch):
    jax_rows(monkeypatch, [pad])
    train, test = planted()
    solver = PSOnlineBatchMF(PSOnlineBatchConfig(
        num_factors=4, iterations=8, learning_rate=0.1,
        lr_schedule="constant", worker_parallelism=4, ps_parallelism=3,
        pull_limit=2, pull_limit_online=4, chunk_size=8, minibatch_size=32,
        seed=0, init_scale=0.3), device="cpu")
    users, items = solver.run(events(train, trigger_at=[4000]),
                              iteration_wait_time=WAIT)
    assert len(users) > 0 and len(items) > 0
    assert [w.batches_run for w in solver.workers] == [1] * 4
    assert [s.batches_seen for s in solver.store.shards] == [1] * 3
    assert all(s.state == "online" for s in solver.store.shards)
    assert sum(len(w.history) for w in solver.workers) == train.n
    assert solver.rmse(test) < 0.35, solver.rmse(test)
    assert solver.online_user_updates and solver.online_item_updates


def drive_rmse(clients, shards, test, cfg_kw):
    """Holdout RMSE of a ``drive`` run's final model: the last emission
    per user and the shards' tables, scored as ``PSOnlineBatchMF``
    scores."""
    m = PSOnlineBatchMF(PSOnlineBatchConfig(**cfg_kw), device="cpu")
    m.user_factors = {int(i): np.asarray(v) for c in clients
                      for (i, v) in c.outputs}
    for sh in shards:
        m.item_factors.update(sh.snapshot())
    return m.rmse(test)


@pytest.mark.parametrize("trigger", [[], [4000]])
@pytest.mark.parametrize("lag", [2, 8])
def test_chunked_matches_per_rating_quality(monkeypatch, trigger, lag):
    """The JAX test's bar (the chunked online path within 0.08 RMSE of the
    per-rating protocol, below 0.45) at 4 workers and 3 shards, on fixed
    message orders: ``drive`` with 2 or 8 pulls left in flight (8 lets the
    chunked groups fill). Threaded runs sample one interleaving each and
    their spread exceeds the bar in both packages, so the order is fixed
    here, and the port's run equals the JAX package's on it (bit for bit
    online only, the online bar with the replay)."""
    train, test = planted(n=8000)
    kw = dict(num_factors=4, iterations=6, learning_rate=0.1,
              lr_schedule="constant", worker_parallelism=4,
              ps_parallelism=3, pull_limit=2, pull_limit_online=4,
              chunk_size=8, minibatch_size=32, seed=0, init_scale=0.3,
              online_chunk_size=16)
    evs = events(train, trigger_at=trigger)
    rmse = {}
    for mode in ("per_rating", "chunked"):
        j, p = run_both(monkeypatch, dict(kw, online_mode=mode), evs,
                        lag=lag)
        assert_same_run(j, p, exact=not trigger)
        assert [w.batches_run for w in p[0]] == [len(trigger)] * 4
        rmse[mode] = drive_rmse(p[2], p[1], test, kw)
    assert abs(rmse["per_rating"] - rmse["chunked"]) < 0.08, rmse
    assert rmse["chunked"] < 0.45, rmse


def test_trigger_improves_over_online_only(monkeypatch):
    jax_rows(monkeypatch, [pad])
    train, test = planted()
    base = dict(num_factors=4, iterations=8, learning_rate=0.1,
                lr_schedule="constant", worker_parallelism=4,
                ps_parallelism=2, pull_limit=2, pull_limit_online=4,
                chunk_size=8, minibatch_size=32, seed=0, init_scale=0.3)
    with_batch = PSOnlineBatchMF(PSOnlineBatchConfig(**base), device="cpu")
    with_batch.run(events(train, trigger_at=[5999]),
                   iteration_wait_time=WAIT)
    online_only = PSOnlineBatchMF(PSOnlineBatchConfig(**base), device="cpu")
    online_only.run(events(train), iteration_wait_time=WAIT)
    assert with_batch.rmse(test) < online_only.rmse(test)


def test_worker_death_in_online_state_fails_run_promptly():
    train, _ = planted(n=2000)
    cfg = PSOnlineBatchConfig(num_factors=4, worker_parallelism=2,
                              ps_parallelism=2, pull_limit_online=4,
                              minibatch_size=32)

    class DyingWorker(OnlineBatchWorkerLogic):
        seen = 0

        def on_recv(self, data, ps):
            self.seen += 1
            if self.worker_id == 0 and self.seen == 50:
                raise RuntimeError("worker died mid-stream")
            super().on_recv(data, ps)

    init = PseudoRandomFactorInitializer(4, scale=0.1)
    store = ShardedParameterStore(lambda p: AdaptivePSLogic(init, 2), 2)
    with pytest.raises(RuntimeError, match="worker died mid-stream"):
        ps_transform(routed(events(train), 2),
                     [DyingWorker(cfg, w, device="cpu") for w in range(2)],
                     store, pull_limit=None, iteration_wait_time=WAIT)


def test_shard_death_during_batch_fails_run_promptly():
    train, _ = planted(n=1500)
    cfg = PSOnlineBatchConfig(num_factors=4, iterations=3,
                              worker_parallelism=2, ps_parallelism=2,
                              pull_limit=2, pull_limit_online=4,
                              chunk_size=8, minibatch_size=32)

    class DyingShard(AdaptivePSLogic):
        def on_control(self, worker_id, payload, outputs):
            if payload == "batch_start":
                raise RuntimeError("shard died at batch start")
            super().on_control(worker_id, payload, outputs)

    init = PseudoRandomFactorInitializer(4, scale=0.1)
    store = ShardedParameterStore(
        lambda p: (DyingShard(init, 2) if p == 1
                   else AdaptivePSLogic(init, 2)), 2)
    with pytest.raises(RuntimeError, match="shard died"):
        ps_transform(routed(events(train, trigger_at=[1000]), 2),
                     [OnlineBatchWorkerLogic(cfg, w, device="cpu")
                      for w in range(2)],
                     store, pull_limit=None, iteration_wait_time=WAIT)


def test_unknown_online_mode_raises():
    with pytest.raises(ValueError, match="online_mode"):
        OnlineBatchWorkerLogic(PSOnlineBatchConfig(online_mode="bogus"), 0,
                               device="cpu")


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for entry in (PSOnlineBatchMF,
                  lambda: OnlineBatchWorkerLogic(PSOnlineBatchConfig(), 0)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry()
