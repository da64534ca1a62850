#!/usr/bin/env python3
"""Run the PyTorch port's DSGD training, serving and evaluation paths, ALS,
online MF, the serving engine, the streaming runtime, the parameter server,
the estimator pipeline, the tiered store, the mesh and the observability
planes on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is nonzero:

1. device   — the card's name and power limit (nvidia-smi), CUDA device name;
2. build    — nvcc builds csrc/dsgd_sweep.cu (sm_90a) and g++ builds
              csrc/fastblock.cpp (the host library), both from the checkout
              and at once;
3. kernels  — the stratum sweep through the step pair (kernel A, item
              rows; kernel B, user rows; driven by the step plan) against
              its plain PyTorch version on the card: a small k=4, rank-128
              problem with duplicate rows and padding (one stratum, 3
              sweeps), ``[kernels.skewed]`` (few, heavily skewed ids: the
              segments longer than the 32-entry chunk, which take a block
              each), and one stratum at the full bench geometry; max-abs
              ≤ 1e-5 per stratum (the plain version's dot order and
              ``index_add_`` atomics), and two kernel runs of each stratum
              bit-equal (no atomics in the kernels). ``[kernels.bf16]``:
              the same with bf16 tables through the flagged route (the
              pair reads a row from its bf16 table at its first step of the
              stratum and writes it back at its last) against the plain
              twin, every element within one bf16 ulp (magnitudes below
              2^-16 counted as 2^-16, where a bf16 ulp is the size of the
              f32 kernel-vs-plain difference), bit-equal to the cast route
              (upcast kernel, f32 steps, downcast kernel) after every
              stratum, both routes' ms on stratum 0 (cast, flagged,
              flagged, cast) beside the route's bound, and the cast kernels
              bit-equal to ``Tensor.to``;
3a. kernels.probe — ``cuda_sgd.probe_variants`` at the JAX probe's
              defaults (rank 128, minibatch 2,048, 5,080 × 1,848 rows,
              24,576 ratings, 5 reps), 16 sweeps a timed call, unsorted and
              sorted, obs on: the ``torch`` and ``cuda`` variants' ratings/s
              (no ``FAILED``, equal to their gauges), the cuda variant's
              plan wall, the step pair launched 12 × 6 × 16 times a probe
              each (its launches join the kernels line), and its one visit
              within 1e-5 of ``block_sweep_reference`` on the same draw;
4. data/host — the bench configuration's ratings at full width:
              ML-25M-shaped (162,541 × 59,047, 25,000,095 ratings, 95/5
              split); ``block_problem`` and ``minibatch_inv_counts`` through
              the native library (as ``fit`` runs them), then once more
              through their numpy plain versions: layouts and collision
              scales must be bit-equal; both walls printed;
5. main     — k=8 Gemulla strata, rank 128, minibatch 32,768, warm_boost
              schedule, 3 sweeps through ``DSGD().fit`` on the card with a
              ``CheckpointManager`` (a snapshot per sweep); the host steps
              before the first sweep (collision scales, factor init,
              host→device copies) are timed apart, and the sweeps inside
              ``fit`` with CUDA events (``DSGD.segment_ms``); holdout RMSE
              after every sweep must be finite and fall, every stratum step
              must have launched both kernels, the plan's build is timed
              apart, and the same 3 sweeps through the plain route on the
              card must end within 1e-4 of its RMSE;
6. main.ckpt — the newest snapshot of that fit deleted, a new solver
              resumes it (``resume=True``) from sweep 2: its tables must be
              bit-equal to the fit's; save wall per segment and bytes
              printed. The same for the bf16 ``fit_device`` of phase 9;
7. serve    — ``model.recommend`` of 16,384 users, k=10, on the fitted
              model (warmed on 2,048): users/s, TFLOP/s (2·users·item
              rows·rank over the wall), its share of the f32 peak and the
              bound; the lists must be well formed, agree with the same
              call on the CPU for 256 users (scores within 1e-5, ids
              wherever scores are not tied), and with ``train=`` hold no
              train item of 2,048 users;
8. eval     — ``model.ranking_quality`` (HR@10, NDCG@10) of 65,536 holdout
              pairs with the train set excluded, and its wall; on the
              first 4,096 pairs HR and NDCG at k = 10 and at k = 1,000
              must agree with the CPU within 1e-3;
9. main.device — the bench's device pipeline (``bench.py:254-363``):
              ``synthetic_like_device`` on the card, device blocking and the
              per-id init timed apart, then ``DSGD().fit_device`` at f32 and
              at bf16, 3 sweeps each, from the same layout and initial
              tables. Holdout RMSE per sweep (``holdout_rows``) must be
              finite and fall, launch counts must equal their formulas (the
              step pair alone: no cast in bf16 either), bf16 must end
              within 5% of f32 (its sweeps printed beside f32's), and the
              plain twin's replay on the card within 1e-4 (f32) / 1e-3
              (bf16) of each fit;
9a. obs.train — the f32 ``fit_device`` again with observability on
              (``obs.enable``, the event journal, the library build hook,
              ``enable_introspection(interval_s=0.25)``,
              ``enable_transfers(guard="log")``), a halting
              ``TrainingWatchdog``, an ``OnlineEvaluator`` on the holdout
              and a snapshot per sweep: tables bit-equal to the
              uninstrumented fit's, 3 timed segments (compile, execute,
              execute), a valid Chrome trace, health OK; the timer's
              steady wall beside the sweeps' CUDA-event ms and beside an
              uninstrumented run's, the segment key's roofline row at the
              card's peak (≤ 100%), a device-memory sample, the implicit
              transfers counted in the fit's guard scope (0: the fit hands
              the kernels' driver its plan) and the libraries' build
              walls; the instrumented-vs-uninstrumented sweep again
              as 5 interleaved pairs (min of each side, every plane off
              for the uninstrumented fits); one steady sweep under ``torch.profiler`` (both
              step kernels, 96 launches each, framed by other kernels; the
              card's busy and idle share over the sweep); the k = 1
              divergence (η 0.3 warm_boost) tripping the watchdog with no
              snapshot of the poisoned sweep and health
              CRITICAL; after ``obs.disable()`` a fit whose obs reads no
              clock and waits on nothing (counted);
9b. obs.recorder — the same fit with the flight recorder sampling every
              0.25 s (``enable_flight_recorder``) beside introspection and
              the ``log`` guard, a ``HealthMonitor`` (watchdog, device
              memory, quality) behind an ``ObsServer`` that a second thread
              scrapes (``/metrics``, ``/healthz``, ``/seriesz``,
              ``/rooflinez``, ``/transferz``, each at least twice) while
              the fit runs: tables bit-equal to the uninstrumented fit's,
              every scrape 200, ``/metrics`` parses, the step pair's
              roofline row, the card's memory and ``eval_rmse`` series (≥ 3
              points), the implicit transfers of [obs.train]; the
              recorder's cost on the steady sweep (interleaved against the
              recorder stopped, min of 5) and one ``sample()``'s wall; the
              k = 1 divergence freezing a bundle that validates, with the
              card's memory and limit (``/healthz`` 503 after it; its
              bytes and write wall); ``/profilez?seconds=1`` 200 with a
              concurrent second capture 409; a ``FleetServer`` over this
              server and a second one (``host`` labels, worst status);
10. timing  — each kernel against its plain version at the main path's
              shapes (CUDA events), with its bound on this card: step 0
              warm, each kernel's mean over the steps of stratum 0 and
              step 0 from a cold L2 (a 128 MB write and read first); the
              kernels' registers, shared memory and resident blocks; per
              step: the plan, the longest segments, the design's bytes,
              and the host time of the launch loop beside the device time;
11. als     — the bench's ALS lines (``bench.py:736-849``) on 2,000,000
              planted ratings at ML-25M width: device plans (rank 256
              geometry) timed and equal, row for row, to the host plans;
              rounds at ranks 64 × 2, 128 × 2, 256 × 1 (CUDA events per
              round, rows/s); 4,096 solved rows of a rank-128 half-step
              against float64 numpy within 3e-3·|x| + 3e-4, the half-step
              split into grams, Cholesky and the rest, beside its bound;
              ``[als.implicit]`` (α 1, rank 128, 2 rounds) with sampled
              HR/NDCG@10 and catalog coverage, card vs CPU within 1e-5;
              ``[als.fit_device]`` (the entry point, rank 64) within 1e-4
              RMSE of the bench route, and with ``implicit_alpha`` 1 one
              weighted launch a half-step, its tables within 1e-3 of the
              bench route's implicit rounds; ``[als.fit]`` (host plans,
              rank 128) in f32 and bf16 grams, RMSE gap < 0.01;
12. als.conv — rank-32 time to holdout RMSE 0.155 on 25,000,095 ratings
              (``bench.py:851-907``), up to 7 rounds; the curve must fall;
12a. kernels.als — the fused ALS half-step (``csrc/als_solve.cu``) at
              ``ml25m_r128.als_fit``'s shapes (23,750,090 ratings, 162,541 ×
              59,047, rank 128), each side: the kernel against its plain
              version and the bucketed route (largest difference over the
              largest |x|, within 2e-4), two launches bit-equal, one launch
              a half-step; its ms (CUDA events, 5 calls) beside the bound
              (the lower grams, right-hand sides, factorisations and
              solves in f32 FMAs at 67 TFLOP/s; the fixed side, the plan
              and the solved table once at 3.35 TB/s), the plain
              version's ms and the bucketed route's (gathers, ``bmm``,
              ``cholesky_ex``, two ``solve_triangular``) as ``library_ms``;
              then the weighted build at ``mpd_ials_r64.ials_fit``'s
              shapes (its 66,346,428 draws coalesced, 1,000,000 ×
              2,262,292, rank 64, α 40, each side's YᵀY as G), checked
              and timed the same way against its own plain version and the
              bucketed implicit route, beside
              ``portbench/reference/ials_counts.py``'s bound;
13. online  — ``OnlineMF.partial_fit`` on the Netflix-shaped stream
              (``bench.py:919-975``): 10 batches of 100,000 at rank 128,
              each synchronized (ratings/s, p50/p99/max, steady half); the
              first 3 also on the CPU (ids equal, tables within rtol 1e-4 /
              atol 1e-5); a snapshot after batch 5 restored bit-equal into
              a fresh model; one batch split into its host and device
              parts; one updates-emitting batch of 20,000.
              ``[online.obs]``: the stream with the model's obs hooks on
              (registry, journal, the transfer plane's ``log`` guard)
              against off, ratings/s as the min of 5 interleaved pairs;
              ``online_batch_s`` p50 beside the batch wall, its count and
              the two counters equal to the batches and ratings applied,
              the implicit transfers at ``online.partial_fit``, the staging
              and emit notes' bytes; under torch's deterministic
              algorithms (the card's ``index_add_`` atomics otherwise vary
              the last places between any two runs) tables bit-equal on
              and off. The ALS and online paths launch none of the four
              kernels.
14. serve.engine — ``ServingEngine`` on the trained ``fit`` model: the
              16,384 users of [serve] in seeded requests of 1–32 users,
              max_batch 1,024 (users/s, flush p50/p99, buckets, shapes, the
              share of the bound beside [serve]'s); lists equal to
              ``model.recommend``'s (tie-aware) and the CPU engine's for
              256 users; ``train=`` serves no train item; a flush of 8
              micro-batches of 1,024 rows in host staging and device
              scoring per micro-batch beside its walls;
              the bf16 engine within 2e-2; the flat int8 two-stage engine
              recall@10 ≥ 0.95; ``apply_delta`` of 1,024 item rows equal to
              a fresh engine (codes bit-equal). ``[serve.admission]``: an
              unmeetable SLO target climbs the ladder to ``degrade``
              (results flagged) and, with default thresholds, to ``shed``
              (``serve`` returns each rejection in its request's place);
              the exact engine again with the transfer plane's ``log``
              guard armed: answers equal, the implicit transfers counted at
              ``serving.serve_rows`` after a warm pass, users/s against the
              unarmed engine;
14a. obs.serve — the exact engine of [serve.engine] again with the request,
              rollout, lineage and critical-path planes on and an
              ``ObsServer`` scraped from a second thread (``/lineagez``,
              ``/criticalpathz``, ``/contentionz``, ``/budgetz``,
              ``/slowz``, ``/metrics``): the request stream, an
              ``apply_delta`` of 4,096 item rows into a second version, the
              stream again. Answers equal to a planes-off engine's through
              the same swap; every flush's stages fsum to its wall;
              ``/slowz`` keeps every request past the 5 ms target; two
              ``/budgetz`` cohorts and a verdict (stamped into lineage);
              both swaps on ``/lineagez``; every scrape 200. The stage
              fractions, the planes' cost on users/s (min of 5 passes,
              interleaved with the planes-off engine) and one
              ``note_flush``'s host µs;
15. serve.two_stage — SERVING_r03.json's geometry on the card (20,000 ×
              1,048,576, rank 64, 512 clusters, 16 probes): build wall,
              index, fast and exact users/s, recall@10 ≥ 0.95, one
              256-row bucket split into routing, probes, overflow, top-kc
              and stage 2 beside their bounds. No serving path launches a
              DSGD kernel;
15a. kernels.stage1 — the flat stage-1 kernels (``csrc/stage1_select.cu``)
              at ``mpd_r64.serve_two_stage``'s bucket: 256 query rows ×
              2,262,292 items at rank 64, top 2,000, ~66 exclusions a row:
              values bit-equal to the score-matrix route (``int8_scores``,
              scales, weights, scatter-min, ``lax_top_k``) and the row sets
              equal but at ties with the 2,000th value, against the plain
              version too; per bucket the kernels' ms (CUDA events, 10
              calls), the bound (2·b·N·r over 1,979 TOP/s int8 and N·(r +
              8) B over 3.35 TB/s), the plain version's ms and the route's
              as ``library_ms``; the call's peak memory above its inputs;
16. streams.log — the event log at the Netflix stream's shape: 32 ×
              100,000 records appended over 4 partitions and read back by a
              new instance (records/s and bytes/s each way; the re-read
              equal to what was appended), a torn tail cut off by the next
              append, one 8-batch ``fsync=True`` leg on its own; the log
              built with an event journal: one ``wal.segment_roll`` per
              roll (directory and bases equal to the segments');
17. streams.driver — 16 batches of one partition drained by
              ``StreamingDriver(OnlineMF)`` (rank 128, checkpoint every 4)
              against the bare ``partial_fit`` loop over the same batches,
              in turns (durable/bare retention, queue high-water,
              checkpoint walls; tables within rtol 1e-4 / atol 1e-5); a
              crash after batch 9, ``resume()`` and drain (zero loss, ≤ 4
              batches replayed; the resumed driver's telemetry exported
              every 0.25 s: ``/metrics`` shows ``streams_lag_records`` equal
              to ``telemetry()``'s lag with a batch pending and after the
              drain, and the exporter stops); a ``serving_engine()`` whose
              delta refresh equals a full refresh row for row;
18. streams.parallel — 32 stratum-routed batches (scripts/streams_bench.py's
              ``_stratum_batch`` rule) drained by ``ParallelIngestRunner``
              at N = 1, 2, 4 consumers on fresh models (ratings/s,
              efficiency, gate waits, barriers; N = 2, 4 tables within
              rtol 1e-4 / atol 1e-5 of N = 1's); a kill and resume at N = 4
              (zero loss, per-partition duplicates ≤ the barrier cadence);
              one refresh of 4 consumers' deltas = one catalog version;
19. streams.adaptive — ``AdaptiveMF`` (rank 128, a background DSGD retrain
              every 4 batches, 3 sweeps) under a ``StreamingDriver`` over 12
              batches: retrain walls, the step pair's launches from the
              retrain thread (> 0), buffered batches replayed after each
              swap, one catalog version per swap, holdout RMSE beside the
              online-only model's; each retrain held against the plain
              route on the card from the same initial tables (a stratum
              at 1e-5, the fit at 1e-5 × sweeps, holdout RMSE within
              1e-4); then one foreground ALS retrain. The log, driver and
              parallel phases launch none of the kernels;
19a. obs.stream — ``StreamingDriver(AdaptiveMF)`` (rank 128, a foreground
              DSGD retrain every 4 batches: the step pair's launches) over
              8 batches and a rotten one (2,000 NaN ratings the queue
              quarantines, 5,000 out-of-range ratings, 12,000 rows of ids
              past the vocabulary), with the lineage, critical-path and
              contention planes and the flight recorder on and a
              ``DataQualityInspector`` behind ``watch_data_quality``: the
              check trips CRITICAL and the bundle it freezes validates
              with live ``lineage.json`` / ``contention.json``;
              ``/criticalpathz``'s samples reconcile with the freshness
              histogram (count, mean ``swap_lag``); under torch's
              deterministic algorithms the tables bit-equal to a planes-off
              run's; ``online.table_growth`` events ending at the tables'
              capacities, ``online_batch_s`` counting every online batch;
              the fleet's
              ``/podtracez`` 200 and valid. ``ParallelIngestRunner`` at N =
              2 (the [streams.parallel] strata) under the contention
              plane: ``/contentionz``'s serial fraction, top contended
              locks and the consumers' CPU fractions, beside the card's
              busy share from a second, profiled N = 2 run; the planes'
              cost on durable ratings/s (min of 5, interleaved);
20. pipeline — ``Pipeline(IdCompactor(), MeanCenterer(), DSGD(cfg))`` on
              2,000,000 of the [main] train ratings at the [main] config
              (k 8, rank 128, minibatch 32,768, 3 sweeps; run after [eval]):
              predictions on 65,536 holdout pairs bit-equal to the same
              stages composed by hand, every stratum step launching the
              step pair (its launches join the kernels line), the strata
              held against the plain route (``check_strata``);
21. ps.offline — ``PSOfflineMF`` at bench.py's PS settings
              (``bench.py:1007-1041``: W 4, P 4, pull_limit 4, chunk 2,048,
              minibatch 4,096, 2 iterations, lr 0.05 η/√t) at [online]'s
              width, rank 128, on 2,000,000 ``netflix_batches`` ratings
              (95/5): ratings/s, pulls, pushes, holdout RMSE below the
              untrained tables'; a W = 1 / P = 1 run on 200,000 of them on
              the card and on the CPU within the [online] bar; one answer
              split into ``ensure``, host → card, ``online_train`` (device
              ms), card → host and the shard's ``np.add.at``;
22. ps.adaptive — ``PSOnlineBatchMF`` (``bench.py:1052-1086``: W 4, P 4,
              chunk 4,096, minibatch 4,096, online chunk 4,096, 2
              iterations) on 400,000 events with one ``BATCH_TRIGGER`` at
              the middle: events/s, the replay wall, one batch per worker,
              holdout RMSE below the online-only run's; the one-worker
              replay driven in one thread on the card and on the CPU
              within the [online] bar;
23. store.tiered — TIERED_r01.json's geometry
              (``scripts/streams_bench.py:282-285``: a 1,000,000-id
              Zipf(1.25) universe, 4,000 items, rank 32, 24 batches of
              20,000, 8,192 slots, a checkpoint every 8, queue capacity 2):
              one WAL drained by ``StreamingDriver`` all-HBM and tiered
              (with the prefetcher): ratings/s, retention, hit rate,
              evictions, write-backs, prefetched rows, demand-fault wait,
              bytes each way and the store's copy GB/s, the device budget
              multiple; user tables within the [online] bar;
              ``ServingEngine(user_store=)`` lists equal to the all-HBM
              engine's (ties within ``SCORE_TOL``); a crash after batch
              12, ``resume()`` re-warms the checkpoint's hot set and the
              drain ends at the uninterrupted run's tables (the
              [online] bar), that resume leg under a live registry:
              ``/storez`` answers the store's ``snapshot()``, the
              ``tier_host_bytes`` series exists and ``watch_store_memory``
              reports OK; an overcommitted pool raises. The PS and store
              phases launch none of the kernels;
24. mesh.visit — the mesh's per-visit route (``block_sweep``) at the main
              path's geometry (k 8, rank 128, minibatch 32,768), each rank
              with the plan a k-rank ring builds (its device-major cells
              ``[k, 1, b]``): all 64 visits of a sweep (every rank, every
              stratum) on block-local slices, f32 and bf16; max-abs 0
              against the stratum's launch loop (each row's entries keep
              their order; in bf16 the stratum's cast route), 1e-5 / one
              bf16 ulp against
              ``block_sweep_reference``; stratum 0's 8 visits (192
              launches, counted) timed against the stratum's 24;
25. mesh.dsgd — an NCCL process group of one rank in this process (its
              all_reduce answers), then ``MeshDSGD.fit_device`` on the
              device pipeline (ML-25M width, the bench settings at η 0.1:
              ``MESH_BENCH``), f32 and bf16, 3 sweeps, a sharded snapshot
              a sweep: tables bit-equal to ``DSGD.fit_device(
              num_blocks=1)``, sweeps timed beside it, a resume from sweep
              2 bit-equal, launches by formula (no cast in bf16); the
              fit's one visit (k 1,
              the whole tables) through ``block_sweep`` on its own layout
              and plan against ``block_sweep_reference`` (1e-5 / one bf16
              ulp);
26. mesh.serve — 16,384 users' top-10 from the mesh model's shards, through
              ``MFModel.recommend(mesh=)`` and ``ServingEngine(mesh=)``,
              each equal to the plain ``recommend`` (tie-aware);
27. mesh.als — ``MeshALS.fit`` against ``ALS.fit`` on [als.fit]'s
              2,000,000 ratings (rank 128, 2 rounds): 3e-3·|x| + 3e-4,
              RMSE within 1e-4. Serving and ALS launch none of the kernels.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits nonzero
and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from large_scale_recommendation_tpu_torch import obs
from large_scale_recommendation_tpu_torch.core.generators import (
    SyntheticMFGenerator,
)
from large_scale_recommendation_tpu_torch.core.initializers import (
    PseudoRandomFactorInitializer,
)
from large_scale_recommendation_tpu_torch.core.types import Ratings
from large_scale_recommendation_tpu_torch.core.updaters import (
    RegularizedSGDUpdater,
    schedule_from_name,
)
from large_scale_recommendation_tpu_torch.data import blocking
from large_scale_recommendation_tpu_torch.data import device_blocking
from large_scale_recommendation_tpu_torch.data.blocking import flat_index
from large_scale_recommendation_tpu_torch.data.movielens import synthetic_like
from large_scale_recommendation_tpu_torch.models.adaptive import (
    AdaptiveMF,
    AdaptiveMFConfig,
)
from large_scale_recommendation_tpu_torch.models.als import ALS, ALSConfig
from large_scale_recommendation_tpu_torch.models.dsgd import DSGD, DSGDConfig
from large_scale_recommendation_tpu_torch.models.mf import MFModel
from large_scale_recommendation_tpu_torch.models.online import (
    OnlineMF,
    OnlineMFConfig,
)
from large_scale_recommendation_tpu_torch.models.pipeline import (
    IdCompactor,
    MeanCenterer,
    Pipeline,
)
from large_scale_recommendation_tpu_torch.ops import _build, cuda_sgd
from large_scale_recommendation_tpu_torch.ops import stage1_select
from large_scale_recommendation_tpu_torch.ops import als as als_ops
from large_scale_recommendation_tpu_torch.ops import sgd as sgd_ops
from large_scale_recommendation_tpu_torch.ops import topk
from large_scale_recommendation_tpu_torch.obs import registry as obs_registry
from large_scale_recommendation_tpu_torch.obs import trace as obs_trace
from large_scale_recommendation_tpu_torch.obs.health import SLOTracker
from large_scale_recommendation_tpu_torch.obs.introspect import TRACE_FILE
from large_scale_recommendation_tpu_torch.obs.server import http_get
from large_scale_recommendation_tpu_torch.parallel import als_mesh, dsgd_mesh
from large_scale_recommendation_tpu_torch.parallel import serving as psrv
from large_scale_recommendation_tpu_torch.parallel.distributed import (
    DistributedConfig,
    initialize_distributed,
)
from large_scale_recommendation_tpu_torch.parallel.partitioner import (
    Partitioner,
)
from large_scale_recommendation_tpu_torch.ps import adaptive as ps_adaptive
from large_scale_recommendation_tpu_torch.ps import core as ps_core
from large_scale_recommendation_tpu_torch.ps import mf as ps_mf
from large_scale_recommendation_tpu_torch.ps import server as ps_server
from large_scale_recommendation_tpu_torch.ps.adaptive import (
    BATCH_TRIGGER,
    PSOnlineBatchConfig,
    PSOnlineBatchMF,
)
from large_scale_recommendation_tpu_torch.ps.mf import (
    PSOfflineMF,
    PSOfflineMFConfig,
)
from large_scale_recommendation_tpu_torch.serving import (
    AdmissionConfig,
    AdmissionController,
    AdmissionRejectedError,
    RetrievalConfig,
    ServingEngine,
    recall_at_k,
)
from large_scale_recommendation_tpu_torch.serving import retrieval as ret_ops
from large_scale_recommendation_tpu_torch.store import (
    StoreStats,
    TieredFactorStore,
)
from large_scale_recommendation_tpu_torch.streams import (
    EventLog,
    ParallelIngestRunner,
    StreamingDriver,
    StreamingDriverConfig,
)
from large_scale_recommendation_tpu_torch.streams.log import (
    HEADER_SIZE,
    RECORD_SIZE,
)
from large_scale_recommendation_tpu_torch.utils import metrics
from large_scale_recommendation_tpu_torch.utils.shapes import next_pow2
from large_scale_recommendation_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    ShardedCheckpointManager,
    restore_online_state,
    save_online_state,
)
from portbench.generators.ials_fit import coalesce
from portbench.reference import generator as bench_data
from portbench.reference import ials_counts

# published H100 SXM peaks (the bound's denominators)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
SOURCE = "large_scale_recommendation_tpu_torch/csrc/dsgd_sweep.cu"
# the step pair replaces the stratum kernel on the main path (and, by the
# same launches, the per-visit _sweep_kernel at pallas_sgd.py:172); the cast
# pair, the earlier route of its half=True branch, now the baseline of the
# flagged bf16 route (the step pair again)
_PALLAS = "large_scale_recommendation_tpu/ops/pallas_sgd.py"
REPLACES = {"sgd_item_rows_kernel": f"{_PALLAS}:440",
            "sgd_user_rows_kernel": f"{_PALLAS}:440",
            "bf16_to_f32_kernel": f"{_PALLAS}:552",
            "f32_to_bf16_kernel": f"{_PALLAS}:604"}
# the bench configuration (bench.py:190-202), 3 sweeps
BENCH = dict(num_factors=128, lambda_=0.1, iterations=3, learning_rate=0.3,
             lr_schedule="warm_boost", seed=0, minibatch_size=32768,
             init_scale=0.08, collision_mode="mean", minibatch_sort="item")
K = 8
RMSE_TARGET = 0.155
# max-abs per stratum, kernels vs plain: the plain version reduces the dot in
# another order and its index_add_ adds duplicates with atomics in any order
STRATUM_TOL = 1e-5
SERVE_USERS, SERVE_WARM, SERVE_K = 16384, 2048, 10  # bench.py:659-686
EVAL_PAIRS, EVAL_CPU_PAIRS = 65536, 4096
SCORE_TOL = 1e-5  # top-K scores, card vs CPU (dot sums in other orders)
BF16_ULPS = 1.0  # bf16 per stratum: an f32 last-place difference may flip
#                  one rounding
# below this magnitude a bf16 ulp (≤ 1.2e-7) is smaller than the f32
# kernel-vs-plain difference it rounds from; ulps count at no less than it
ULP_FLOOR = 2.0 ** -16


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_args(problem, icu, icv, dev):
    """The stratum-major arrays on the card, in ``dsgd_train`` order."""
    r = problem.ratings

    def put(a, dtype):
        return torch.as_tensor(a, dtype=dtype).to(dev)

    return (put(r.u_rows, torch.int32), put(r.i_rows, torch.int32),
            put(r.values, torch.float32), put(r.weights, torch.float32),
            put(problem.users.omega, torch.float32),
            put(problem.items.omega, torch.float32),
            put(icu, torch.float32), put(icv, torch.float32))


def stratum_operands(args, problem, minibatch):
    su, si, sv, sw, ou, ov, icu, icv = args
    return cuda_sgd.build_stratum_operands(
        su, si, sv, sw, icu, icv, ou, ov, num_blocks=problem.ratings.num_blocks,
        rpb_u=problem.users.rows_per_block,
        rpb_v=problem.items.rows_per_block, minibatch=minibatch)


def max_abs(pairs) -> float:
    return max(float((a - b).abs().max()) for a, b in pairs)


def step_plan(args, minibatch):
    su, si, sv, sw, _, _, icu, icv = args
    return cuda_sgd.build_step_plan(su, si, sv, sw, icu, icv,
                                    minibatch=minibatch)


def check_strata(U, V, args, problem, plan, lr, lam, label):
    """Kernel vs plain for every stratum of one sweep, each from the same
    tables, and a second kernel run of each stratum bit-equal to the first;
    returns the largest max-abs difference."""
    k = problem.ratings.num_blocks
    ou, ov = args[4], args[5]
    idx, streams = stratum_operands(args, problem, plan.minibatch)
    work = plan.new_work(U.shape[-1])
    worst = 0.0
    for s in range(k):
        runs = []
        for _ in range(2):
            Uk, Vk = U.clone(), V.clone()
            cuda_sgd.stratum_sweep(Uk, Vk, ou, ov, plan, s, work, lr=lr,
                                   lam=lam)
            runs.append((Uk, Vk))
        Ur, Vr = cuda_sgd.stratum_sweep_reference(
            U, V, idx, streams, s, lr=lr, lam=lam, minibatch=plan.minibatch,
            num_blocks=k)
        torch.cuda.synchronize()
        err = max_abs([(Uk, Ur), (Vk, Vr)])
        if not (err <= STRATUM_TOL and torch.isfinite(Uk).all()):
            raise AssertionError(f"{label}: stratum {s} max-abs {err:.3e} > "
                                 f"{STRATUM_TOL:.0e}")
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            raise AssertionError(f"{label}: stratum {s}: two kernel runs "
                                 "differ")
        worst = max(worst, err)
    return worst


def bf16_ulps(a, b, floor=ULP_FLOOR) -> torch.Tensor:
    """|a − b| per element in units of one bf16 ulp at its magnitude
    (counted at no less than ``floor``)."""
    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs()).clamp_min(floor)
    return (a - b).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)


def check_strata_bf16(U, V, args, problem, plan, lr, lam, label):
    """bf16 tables through the flagged route (``stratum_sweep(...,
    store=)`` on NaN work tables) against the plain twin
    (``stratum_sweep_reference`` on the bf16 tables) for every stratum of
    one sweep, each from the same tables, and against the cast route
    (``stratum_sweep_cast``): bit-equal, or raise. Returns the largest
    difference in bf16 ulps, the share of elements that differ, and (how
    many, largest magnitude) of those beyond one ulp only when counted
    below ``ULP_FLOOR``."""
    k = problem.ratings.num_blocks
    ou, ov = args[4], args[5]
    minibatch = plan.minibatch
    idx, streams = stratum_operands(args, problem, minibatch)
    work = plan.new_work(U.shape[-1])
    Ub, Vb = U.to(torch.bfloat16), V.to(torch.bfloat16)
    Uw, Vw = torch.empty_like(U), torch.empty_like(V)
    worst, differ, total, tiny, tiny_mag = 0.0, 0, 0, 0, 0.0
    for s in range(k):
        Uk, Vk = Ub.clone(), Vb.clone()
        Uw.fill_(float("nan"))
        Vw.fill_(float("nan"))
        cuda_sgd.stratum_sweep(Uw, Vw, ou, ov, plan, s, work, lr=lr,
                               lam=lam, store=(Uk, Vk))
        Uc, Vc = cuda_sgd.stratum_sweep_cast(Ub.clone(), Vb.clone(), Uw, Vw,
                                             ou, ov, plan, s, work, lr=lr,
                                             lam=lam)
        Ur, Vr = cuda_sgd.stratum_sweep_reference(
            Ub, Vb, idx, streams, s, lr=lr, lam=lam, minibatch=minibatch,
            num_blocks=k)
        torch.cuda.synchronize()
        if not all(torch.equal(a.view(torch.int16), b.view(torch.int16))
                   for a, b in ((Uk, Uc), (Vk, Vc))):
            raise AssertionError(f"{label} bf16: stratum {s}: the flagged "
                                 "route differs from the cast route")
        for a, b in ((Uk, Ur), (Vk, Vr)):
            worst = max(worst, float(bf16_ulps(a, b).max()))
            differ += int((a.view(torch.int16) != b.view(torch.int16)).sum())
            total += a.numel()
            # beyond one ulp only when counted below the floor
            raw = bf16_ulps(a, b, floor=2.0 ** -126) > BF16_ULPS
            tiny += int(raw.sum())
            if raw.any():
                tiny_mag = max(tiny_mag, float(a.float().abs()[raw].max()))
        if not (worst <= BF16_ULPS and torch.isfinite(Uk.float()).all()):
            raise AssertionError(f"{label} bf16: stratum {s} differs by "
                                 f"{worst} bf16 ulps > {BF16_ULPS}")
    return worst, differ / total, (tiny, tiny_mag)


def stratum_bound_ms(plan, rank, s, half):
    """The least time of stratum ``s``'s function on this card: its steps'
    bounds (each distinct row of a step read and written once with its ω,
    24 B of streams a slot), less, on bf16 tables (``half``), 2 B a column
    of each distinct row's first read and last write in the stratum."""
    row = rank * 4
    n_all = plan.visits * plan.minibatch
    steps = range(s * plan.n_mb, (s + 1) * plan.n_mb)
    nbytes = sum((plan.u_segments[g] + plan.v_segments[g]) * (2 * row + 4)
                 + n_all * 24 for g in steps)
    if half:
        nbytes -= (plan.u_touched[s] + plan.v_touched[s]) * row
    flops = sum(plan.entry_base[g + 1] - plan.entry_base[g]
                for g in steps) * 12 * rank
    return bound_of(nbytes, flops)[0]


def bf16_route_ms(U, V, args, plan, lr, lam, reps=3):
    """Stratum 0 on bf16 tables by each route, cast, flagged, flagged, cast
    (CUDA events, each from the same tables, every launch of the route
    inside; the best of ``reps`` a turn): ``{route: [ms, ms]}``. These
    launches are not counted."""
    ou, ov = args[4], args[5]
    work = plan.new_work(U.shape[-1])
    Ub, Vb = U.to(torch.bfloat16), V.to(torch.bfloat16)
    Uw, Vw = torch.empty_like(U), torch.empty_like(V)
    routes = {
        "flagged": lambda A, B: cuda_sgd.stratum_sweep(
            Uw, Vw, ou, ov, plan, 0, work, lr=lr, lam=lam, store=(A, B)),
        "cast": lambda A, B: cuda_sgd.stratum_sweep_cast(
            A, B, Uw, Vw, ou, ov, plan, 0, work, lr=lr, lam=lam)}
    out = {"cast": [], "flagged": []}
    for name in ("cast", "flagged", "flagged", "cast"):
        best = math.inf
        for _ in range(reps):
            A, B = Ub.clone(), Vb.clone()
            a, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            routes[name](A, B)
            e.record()
            e.synchronize()
            best = min(best, a.elapsed_time(e))
        out[name].append(best)
    return out


def check_casts(U, V):
    """The cast kernels against ``Tensor.to`` on the given f32 tables (and
    back): bit-equal, or raise."""
    Ub, Vb = (torch.empty_like(t, dtype=torch.bfloat16) for t in (U, V))
    Uf, Vf = torch.empty_like(U), torch.empty_like(V)
    cuda_sgd.f32_to_bf16(U, V, Ub, Vb)
    cuda_sgd.bf16_to_f32(Ub, Vb, Uf, Vf)
    torch.cuda.synchronize()
    for got, want in ((Ub, U.to(torch.bfloat16)), (Vb, V.to(torch.bfloat16))):
        if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
            raise AssertionError("f32_to_bf16_kernel differs from Tensor.to")
    if not (torch.equal(Uf, Ub.float()) and torch.equal(Vf, Vb.float())):
        raise AssertionError("bf16_to_f32_kernel differs from Tensor.to")
    return U.numel() + V.numel()


def phase_small(dev):
    """k=4, rank 128, skewed ids (duplicate rows inside minibatches) and
    weight-0 block padding."""
    gen = SyntheticMFGenerator(num_users=2000, num_items=1500, rank=16,
                               noise=0.1, seed=3, skew_lam=2.0)
    train = gen.generate(60_000)
    mb, k, rank, lam = 1024, 4, 128, 0.1
    problem = blocking.block_problem(train, num_blocks=k, seed=0,
                                     minibatch_multiple=mb)
    args = device_args(problem,
                       *blocking.minibatch_inv_counts(problem.ratings, mb),
                       dev)
    sw = problem.ratings.weights
    g = torch.Generator(device=dev).manual_seed(0)
    U = 0.08 * torch.rand((problem.users.num_rows, rank), generator=g,
                          device=dev)
    V = 0.08 * torch.rand((problem.items.num_rows, rank), generator=g,
                          device=dev)
    plan = step_plan(args, mb)
    one = check_strata(U, V, args, problem, plan, 0.75, lam, "small")
    sched = schedule_from_name("warm_boost", lam)
    Uk, Vk = cuda_sgd.dsgd_train_cuda(U, V, *args, lr=0.3, lam=lam,
                                      minibatch=mb, num_blocks=k,
                                      iterations=3, schedule=sched)
    idx, streams = stratum_operands(args, problem, mb)
    Ur, Vr = U, V
    for sweep in range(3):
        for s in range(k):
            Ur, Vr = cuda_sgd.stratum_sweep_reference(
                Ur, Vr, idx, streams, s, lr=sched(0.3, sweep + 1), lam=lam,
                minibatch=mb, num_blocks=k)
    torch.cuda.synchronize()
    err3 = max_abs([(Uk, Ur), (Vk, Vr)])
    if not err3 <= STRATUM_TOL * 3 * k:
        raise AssertionError(f"small: 3 sweeps max-abs {err3:.3e}")
    say("kernels.small", k=k, rank=rank, minibatch=mb,
        pad_fraction=round(float((sw == 0).mean()), 4),
        longest_segment_u=max(plan.longest_u),
        longest_segment_v=max(plan.longest_v), chunk=plan.chunk,
        long_segments=len(plan.u_long) + len(plan.v_long),
        two_runs_bit_equal=True,
        one_stratum_max_abs=f"{one:.3e}", three_sweeps_max_abs=f"{err3:.3e}",
        tol_per_stratum=STRATUM_TOL)
    ulps, share, below = check_strata_bf16(U, V, args, problem, plan, 0.75,
                                           lam, "small")
    route_ms = bf16_route_ms(U, V, args, plan, 0.75, lam)
    kw = dict(lr=0.3, lam=lam, minibatch=mb, num_blocks=k, iterations=3,
              schedule=sched)
    Ub, Vb = U.to(torch.bfloat16), V.to(torch.bfloat16)
    Uk, Vk = cuda_sgd.dsgd_train_cuda(Ub, Vb, *args, **kw)
    Ur, Vr = cuda_sgd.dsgd_train_reference(Ub, Vb, *args, **kw)
    torch.cuda.synchronize()
    say("kernels.bf16", problem="small", k=k, rank=rank, minibatch=mb,
        one_stratum_max_ulps=ulps, one_stratum_share_differ=share,
        beyond_one_ulp_below_floor=below[0], their_max_magnitude=below[1],
        bit_equal_to_cast_route=True,
        cast_route_stratum0_ms=route_ms["cast"],
        flagged_route_stratum0_ms=route_ms["flagged"],
        three_sweeps_max_abs=f"{max_abs([(Uk.float(), Ur.float()), (Vk.float(), Vr.float())]):.3e}",
        cast_elements_bit_equal=check_casts(U, V), tol_ulps=BF16_ULPS)


def phase_skewed(dev):
    """Few, heavily skewed ids: segments many times the chunk long run on
    blocks of their own. Kernel vs plain per stratum, and bit-equal
    reruns."""
    gen = SyntheticMFGenerator(num_users=24, num_items=16, rank=8,
                               noise=0.1, seed=6, skew_lam=3.0)
    mb, k, rank = 2048, 2, 128
    problem = blocking.block_problem(gen.generate(20_000), num_blocks=k,
                                     seed=0, minibatch_multiple=mb)
    args = device_args(problem,
                       *blocking.minibatch_inv_counts(problem.ratings, mb),
                       dev)
    g = torch.Generator(device=dev).manual_seed(1)
    U = 0.1 * torch.rand((problem.users.num_rows, rank), generator=g,
                         device=dev)
    V = 0.1 * torch.rand((problem.items.num_rows, rank), generator=g,
                         device=dev)
    plan = step_plan(args, mb)
    longest = (max(plan.longest_u), max(plan.longest_v))
    if min(longest) <= plan.chunk:
        raise AssertionError(f"skewed: longest segments {longest} do not "
                             f"exceed the chunk {plan.chunk}")
    err = check_strata(U, V, args, problem, plan, 0.05, 0.1, "skewed")
    say("kernels.skewed", k=k, rank=rank, minibatch=mb,
        longest_segment_u=longest[0], longest_segment_v=longest[1],
        chunk=plan.chunk, long_segments=len(plan.u_long) + len(plan.v_long),
        one_stratum_max_abs=f"{err:.3e}", two_runs_bit_equal=True,
        tol_per_stratum=STRATUM_TOL)


# the JAX probe's defaults (pallas_sgd.py:882-885: one ML-25M block visit
# at k = 32), 16 sweeps a timed call (scripts/pallas_probe.py's advice)
PROBE = dict(rank=128, mb=2048, rpb_u=5080, rpb_v=1848, nnz=24576, reps=5)
PROBE_SWEEPS = 16


def phase_kernels_probe(smi):
    """``probe_variants`` at the JAX defaults, 16 sweeps a timed call,
    unsorted and sorted, with obs on: both variants' ratings/s and the cuda
    variant's plan wall, no ``FAILED``, the rates in the
    ``pallas_probe_ratings_per_s`` gauges, the step pair launched steps ×
    (1 + reps) × sweeps times a probe each; then the cuda variant's tables
    after one visit against ``block_sweep_reference`` on the same draw
    (max-abs ≤ 1e-5; these launches are not counted). Returns the probes'
    launch counts."""
    reg, _ = obs.enable()
    cuda_sgd.reset_launch_counts()
    rates = {}
    for sort in (False, True):
        rates[sort] = cuda_sgd.probe_variants(sort=sort, sweeps=PROBE_SWEEPS,
                                              **PROBE)
    launches = dict(cuda_sgd.LAUNCHES)
    gauges = {(m["labels"]["variant"], m["labels"]["sorted"]): m["value"]
              for m in reg.snapshot()["metrics"]
              if m["name"] == "pallas_probe_ratings_per_s"}
    obs.disable()
    e = PROBE["nnz"] - PROBE["nnz"] % PROBE["mb"]
    steps = e // PROBE["mb"]
    want = 2 * steps * (1 + PROBE["reps"]) * PROBE_SWEEPS
    errs = {}
    for sort in (False, True):
        gen = torch.Generator(device="cuda").manual_seed(0)
        inputs = cuda_sgd._probe_inputs(
            gen, PROBE["rank"], PROBE["mb"], PROBE["rpb_u"], PROBE["rpb_v"],
            e, sort)
        got = cuda_sgd._probe_setups(
            inputs, mb=PROBE["mb"], sweeps=1, lr=0.1, lam=0.1,
            rates=cuda_sgd.ProbeRates())["cuda"]()()
        ref = cuda_sgd.block_sweep_reference(
            *inputs[8:], *inputs[:8], lr=0.1, lam=0.1, minibatch=PROBE["mb"])
        torch.cuda.synchronize()
        errs[sort] = max_abs(zip(got, ref))
    say("kernels.probe", card=smi, **PROBE, sweeps=PROBE_SWEEPS, ratings=e,
        steps=steps, **{f"{'sorted' if s else 'unsorted'}_{v}_ratings_per_s":
                        r[v] for s, r in rates.items() for v in r},
        **{f"{'sorted' if s else 'unsorted'}_cuda_plan_s": r.plan_s
           for s, r in rates.items()},
        **{f"{'sorted' if s else 'unsorted'}_one_visit_max_abs": f"{x:.3e}"
           for s, x in errs.items()}, launches=launches,
        launches_want_each=want, tol=STRATUM_TOL)
    failed = {(s, v): r for s, rs in rates.items() for v, r in rs.items()
              if not isinstance(r, float)}
    if failed or set(rates[False]) != set(cuda_sgd.PROBE_VARIANTS):
        raise AssertionError(f"kernels.probe: {failed or rates}")
    if gauges != {(v, str(s).lower()): r for s, rs in rates.items()
                  for v, r in rs.items()}:
        raise AssertionError(f"kernels.probe: gauges {gauges}")
    if (launches["sgd_item_rows_kernel"] != want
            or launches["sgd_user_rows_kernel"] != want
            or launches["bf16_to_f32_kernel"]
            or launches["f32_to_bf16_kernel"]):
        raise AssertionError(f"kernels.probe: launches {launches}, expected "
                             f"{want} of each step kernel")
    if not max(errs.values()) <= STRATUM_TOL:
        raise AssertionError(f"kernels.probe: one visit max-abs {errs}")
    return launches


class HoldoutEval:
    """Segment hook of ``DSGD``: holdout RMSE of the live tables after each
    sweep (the rows come from the same deterministic blocking fit runs)."""

    def __init__(self, problem, holdout, dev):
        ru, ri, rv, rw = holdout.to_numpy()
        u_rows, u_mask = problem.users.rows_for(ru)
        i_rows, i_mask = problem.items.rows_for(ri)
        mask = (u_mask * i_mask * rw).astype(np.float32)
        self.n = float(mask.sum())
        self.rows = [torch.as_tensor(a).to(dev)
                     for a in (u_rows, i_rows, rv, mask)]
        self.rmse: list[float] = []

    def on_segment(self, U, V, label, step):
        sse = float(sgd_ops.sse_rows(U, V, *self.rows))
        self.rmse.append(math.sqrt(sse / self.n))


def build_all() -> dict[str, float]:
    """Build both native sources at once (nvcc and g++ run in parallel);
    returns each build's seconds."""

    def build(name):
        t0 = time.perf_counter()
        _build.load_library(name)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(2) as pool:
        futures = {n: pool.submit(build, n) for n in ("dsgd_sweep",
                                                      "fastblock")}
        return {n: f.result() for n, f in futures.items()}


class TimedCheckpoints(CheckpointManager):
    """A ``CheckpointManager`` that records each save's wall (the
    device→host copy and the .npz write) and the file's size."""

    def __init__(self, directory):
        super().__init__(directory, keep=3)
        self.saves: list[tuple[float, int]] = []

    def save(self, step, arrays, meta=None):
        t0 = time.perf_counter()
        path = super().save(step, arrays, meta)
        self.saves.append((time.perf_counter() - t0, os.path.getsize(path)))
        return path


def check_resume(label, manager, model, refit):
    """Delete the newest snapshot of a finished checkpointed fit, resume
    with a new solver (``refit(resume=True)``), and require tables
    bit-equal to the uninterrupted fit's."""
    newest = manager.latest_step()
    saves = list(manager.saves)  # the fit's own (the resume saves again)
    os.unlink(manager.path(newest))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resumed = refit()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    equal = (torch.equal(resumed.U, model.U)
             and torch.equal(resumed.V, model.V))
    say("main.ckpt", path=label, dtype=str(model.U.dtype).split(".")[-1],
        saves=len(saves), save_wall_s_per_segment=[w for w, _ in saves],
        bytes_per_save=saves[-1][1],
        resumed_from_step=newest - 1, resume_wall_s=wall, bit_equal=equal)
    if not equal:
        raise AssertionError(f"{label}: resumed tables differ from the "
                             "uninterrupted fit's")


def same_problem(a, b) -> bool:
    """Two host blockings give the same layout, bit for bit."""
    for side in ("users", "items"):
        for f in ("ids", "omega", "sorted_ids", "sorted_rows"):
            if not np.array_equal(getattr(getattr(a, side), f),
                                  getattr(getattr(b, side), f)):
                return False
    return all(np.array_equal(getattr(a.ratings, f), getattr(b.ratings, f))
               for f in ("u_rows", "i_rows", "values", "weights"))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as scratch:
        return run(scratch)


def run(scratch: str) -> int:
    """Every phase; checkpoints go under ``scratch``."""
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    say("device", name=kind, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    print(smi, flush=True)

    builds = build_all()
    say("build", **{f"{n}_s": round(t, 2) for n, t in builds.items()})
    for line in _build.build_log.get("dsgd_sweep", "").splitlines():
        if ("Compiling entry" in line or "registers" in line
                or "spill" in line):
            print("  ptxas:", line.strip(), flush=True)

    phase_small(dev)
    phase_skewed(dev)
    probe_launches = phase_kernels_probe(smi)

    # -- main path data: bench.py's host pipeline --------------------------
    t0 = time.perf_counter()
    train, holdout = synthetic_like("ml-25m", rank=16, noise=0.1, seed=0,
                                    skew_lam=2.0)
    gen_s = time.perf_counter() - t0
    cfg = DSGDConfig(**BENCH)
    mb = cfg.minibatch_size
    walls = {}

    def host_block(native):
        t0 = time.perf_counter()
        out = blocking.block_problem(train, num_blocks=K, seed=cfg.seed,
                                     minibatch_multiple=mb,
                                     minibatch_sort=cfg.minibatch_sort,
                                     native=native)
        walls["native" if native else "numpy"] = time.perf_counter() - t0
        return out

    problem = host_block(native=True)  # as fit blocks
    if not same_problem(problem, host_block(native=False)):
        raise AssertionError("native blocking differs from the numpy route")
    b = problem.ratings.u_rows.shape[-1]
    n_mb = b // mb
    say("data", train=train.n, holdout=holdout.n,
        users=problem.users.num_rows, items=problem.items.num_rows,
        rows_per_block=f"{problem.users.rows_per_block}/"
                       f"{problem.items.rows_per_block}",
        block_nnz=b, n_mb=n_mb, max_pad_ratio=round(
            problem.ratings.max_pad_ratio, 4),
        gen_wall_s=round(gen_s, 2), blocking_wall_s=walls["native"],
        blocking_numpy_wall_s=walls["numpy"], native_equals_numpy=True)
    t0 = time.perf_counter()
    icu, icv = blocking.minibatch_inv_counts(problem.ratings, mb)
    inv_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = blocking.minibatch_inv_counts(problem.ratings, mb, native=False)
    inv_numpy_s = time.perf_counter() - t0
    if not (np.array_equal(icu, ref[0]) and np.array_equal(icv, ref[1])):
        raise AssertionError("native collision scales differ from numpy's")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    U0, V0 = DSGD(cfg)._init_factors(problem)  # keyed rows, on the card
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    args = device_args(problem, icu, icv, dev)
    U0, V0 = U0.to(dev), V0.to(dev)
    torch.cuda.synchronize()
    copy_s = time.perf_counter() - t0
    # the same host steps fit runs before its first sweep, timed apart
    say("host", inv_counts_wall_s=inv_s, inv_counts_numpy_wall_s=inv_numpy_s,
        inv_counts_native_equals_numpy=True, init_factors_wall_s=init_s,
        host_to_device_wall_s=copy_s,
        host_to_device_bytes=sum(a.nbytes for a in args)
        + U0.nbytes + V0.nbytes)
    lam = cfg.lambda_
    sched = schedule_from_name(cfg.lr_schedule, lam)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = step_plan(args, mb)  # ends in a host read
    plan_s = time.perf_counter() - t0
    full = check_strata(U0, V0, args, problem, plan,
                        sched(cfg.learning_rate, 1), lam, "full")
    say("kernels.full", k=K, rank=cfg.num_factors, minibatch=mb,
        one_stratum_max_abs=f"{full:.3e}", two_runs_bit_equal=True,
        tol_per_stratum=STRATUM_TOL)
    ulps, share, below = check_strata_bf16(
        U0, V0, args, problem, plan, sched(cfg.learning_rate, 1), lam, "full")
    route_ms = bf16_route_ms(U0, V0, args, plan, sched(cfg.learning_rate, 1),
                             lam)
    bf16_bound = stratum_bound_ms(plan, cfg.num_factors, 0, True)
    say("kernels.bf16", problem="full", k=K, rank=cfg.num_factors,
        minibatch=mb, one_stratum_max_ulps=ulps,
        one_stratum_share_differ=share, beyond_one_ulp_below_floor=below[0],
        their_max_magnitude=below[1], bit_equal_to_cast_route=True,
        cast_route_stratum0_ms=route_ms["cast"],
        flagged_route_stratum0_ms=route_ms["flagged"],
        stratum0_bound_ms=bf16_bound,
        f32_stratum0_bound_ms=stratum_bound_ms(plan, cfg.num_factors, 0,
                                               False),
        flagged_share_of_bound=bf16_bound / min(route_ms["flagged"]),
        cast_share_of_bound=bf16_bound / min(route_ms["cast"]),
        flag_bytes=plan.v_flag.nbytes + plan.u_flag.nbytes,
        cast_elements_bit_equal=check_casts(U0, V0), tol_ulps=BF16_ULPS)

    # -- the main path: DSGD().fit on the card, a snapshot per sweep ---------
    solver = DSGD(cfg)
    solver.evaluator = HoldoutEval(problem, holdout, dev)
    fit_ckpt = TimedCheckpoints(os.path.join(scratch, "fit"))
    torch.cuda.synchronize()
    cuda_sgd.reset_launch_counts()
    t0 = time.perf_counter()
    model = solver.fit(train, num_blocks=K, checkpoint_manager=fit_ckpt,
                       checkpoint_every=1)
    rmse = model.rmse(holdout)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(cuda_sgd.LAUNCHES)
    curve = solver.evaluator.rmse
    sweep_ms = solver.segment_ms  # one segment = one sweep, inside fit
    nnz = problem.ratings.nnz
    say("main.fit", wall_s=round(fit_s, 2), plan_build_s=solver.plan_s,
        sweep_ms=sweep_ms,
        ratings_per_s=nnz * len(sweep_ms) / (sum(sweep_ms) / 1e3),
        rmse_per_sweep=curve, rmse=rmse, launches=launches)
    if not all(math.isfinite(x) for x in curve) or len(curve) != 3:
        raise AssertionError(f"holdout RMSE curve {curve}")
    if not all(b_ < a_ for a_, b_ in zip(curve, curve[1:])):
        raise AssertionError(f"holdout RMSE did not fall every sweep: {curve}")
    if abs(rmse - curve[-1]) > 1e-6:
        raise AssertionError(f"model.rmse {rmse} != last sweep {curve[-1]}")
    if len(sweep_ms) != cfg.iterations:
        raise AssertionError(f"fit timed {len(sweep_ms)} sweeps")
    check_launches(launches, n_mb, cfg.iterations)
    if tuple(model.U.shape) != (problem.users.num_rows, cfg.num_factors):
        raise AssertionError(f"U shape {tuple(model.U.shape)}")

    # -- the same 3 sweeps on the plain route, and through the kernels again,
    # from the same initial tables (for the comparison only) ---------------
    def replay(step):
        U, V, out = U0, V0, []
        for sweep in range(cfg.iterations):
            a, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            U, V = step(U, V, sweep)
            e.record()
            e.synchronize()
            out.append(a.elapsed_time(e))
        ev = solver.evaluator
        return out, math.sqrt(float(sgd_ops.sse_rows(U, V, *ev.rows)) / ev.n)

    upd = RegularizedSGDUpdater(learning_rate=cfg.learning_rate, lambda_=lam,
                                schedule=sched)
    replay_ms, rmse_replay = replay(lambda U, V, sweep: cuda_sgd.dsgd_train_cuda(
        U, V, *args, lr=cfg.learning_rate, lam=lam, minibatch=mb,
        num_blocks=K, iterations=1, schedule=sched, t0=sweep, plan=plan))
    plain_ms, rmse_plain = replay(lambda U, V, sweep: sgd_ops.dsgd_train(
        U, V, *args, updater=upd, minibatch=mb, num_blocks=K, iterations=1,
        t0=sweep))
    say("main.replay", kernel_ms=replay_ms, plain_ms=plain_ms,
        model_bytes_per_sweep=sgd_ops.dsgd_bytes_per_sweep(
            nnz, cfg.num_factors, kernel="cuda",
            user_rows=sum(plan.u_segments),
            item_rows=sum(plan.v_segments)),
        rmse_kernel_replay=rmse_replay, rmse_plain=rmse_plain)
    if not abs(rmse_plain - rmse) <= 1e-4:
        raise AssertionError(f"plain route RMSE {rmse_plain} vs kernel "
                             f"{rmse}: differ by more than 1e-4")
    say("main.target", rmse=rmse, target=RMSE_TARGET,
        reached=rmse <= RMSE_TARGET)
    check_resume("fit", fit_ckpt, model, lambda: DSGD(cfg).fit(
        train, num_blocks=K, checkpoint_manager=fit_ckpt, checkpoint_every=1,
        resume=True))
    cpu_model = MFModel(U=model.U.cpu(), V=model.V.cpu(), users=model.users,
                        items=model.items)
    serve_share = phase_serve(model, cpu_model, train)
    phase_serve_engine(model, cpu_model, train, serve_share)
    obs_serve_launches = phase_obs_serve(model, smi)
    phase_eval(model, cpu_model, train, holdout)
    pipeline_launches = phase_pipeline(train, holdout, dev)
    del train, holdout, model, solver, cpu_model
    phase_serve_two_stage(dev)
    phase_kernels_stage1(dev)

    device_runs, (Ud, Vd), obs_data = phase_device(dev, cfg, scratch)
    paths = {"fit": launches, "kernels.probe": probe_launches,
             **device_runs}
    paths["obs.train"], implicit = phase_obs_train(cfg, scratch, obs_data)
    paths["obs.recorder"] = phase_obs_recorder(cfg, scratch, obs_data, smi,
                                               implicit)
    del obs_data
    kernels = time_kernels(U0, V0, args, plan, plan_s, lam, paths)
    kernels += time_casts(Ud, Vd, paths)
    del Ud, Vd
    # [mesh.visit]'s data (the main path's k = 8 layout), kept for the end
    visit_args = (U0, V0, args, problem, plan,
                  sched(cfg.learning_rate, 1), lam)
    del U0, V0, args, plan
    phase_als(dev)
    phase_als_conv(dev)
    phase_kernels_als(dev)
    phase_online(dev, scratch, smi)
    paths["streams.adaptive"] = phase_streams(scratch)
    paths["obs.serve"] = obs_serve_launches
    paths["obs.stream"] = phase_obs_stream(scratch, smi)
    paths["pipeline"] = pipeline_launches
    phase_ps_store(scratch, dev)
    paths.update(phase_mesh(dev, scratch, visit_args))
    del visit_args
    for k in kernels:  # the retrain thread's launches join the counts
        k["launches"], k["launches_by_path"] = launch_counts(paths,
                                                             k["name"])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def check_launches(launches, n_mb, iterations):
    """Each stratum step launched both step kernels, and nothing else ran:
    no cast, in f32 or in bf16 (the flagged route)."""
    steps = n_mb * K * iterations
    want = {"sgd_item_rows_kernel": steps, "sgd_user_rows_kernel": steps,
            "bf16_to_f32_kernel": 0, "f32_to_bf16_kernel": 0}
    if launches != want:
        raise AssertionError(
            f"launches {launches}, expected {want} (2·n_mb·k·iterations "
            "step launches, no cast)")


class DeviceHoldoutEval:
    """Segment hook of ``DSGD``: holdout RMSE of the live tables after each
    sweep, on the rows of ``DeviceBlockedProblem.holdout_rows``."""

    def __init__(self, ur, ir, values, mask):
        self.rows = (ur, ir, values, mask)
        self.n = float(mask.sum())
        self.rmse: list[float] = []

    def on_segment(self, U, V, label, step):
        sse = float(sgd_ops.sse_rows(U, V, *self.rows))
        self.rmse.append(math.sqrt(sse / self.n))

    def of(self, U, V) -> float:
        return math.sqrt(float(sgd_ops.sse_rows(U, V, *self.rows)) / self.n)


def phase_device(dev, cfg, scratch):
    """The bench's device pipeline at full width: generation, blocking and
    init on the card (timed apart), then ``DSGD.fit_device`` at f32 and at
    bf16, each against the plain twin's replay on the card from the same
    layout and initial tables; the bf16 fit snapshots each sweep and is
    resumed from its second. Returns each fit's launch counts, the initial
    f32 tables and what ``[obs.train]`` reruns (the data, the layout's
    operands, the f32 fit's tables and sweep times)."""

    (train, hold, (nu, ni)), gen_s = timed(
        lambda: device_blocking.synthetic_like_device(
            "ml-25m", rank=16, noise=0.1, seed=0, skew_lam=2.0, device=dev))
    u, i, r = train
    mb = cfg.minibatch_size
    def block():
        return device_blocking.device_block_problem(
            u, i, r, nu, ni, num_blocks=K, minibatch_multiple=mb,
            seed=cfg.seed, minibatch_sort=cfg.minibatch_sort, device=dev)

    problem, block_s = timed(block)  # cold: the first sorts load kernels
    _, block_warm_s = timed(block)  # as fit_device meets it
    (U0, V0), init_s = timed(lambda: device_blocking.init_factors_device(
        problem, cfg.num_factors, cfg.init_scale))
    b = problem.su.shape[-1]
    n_mb = b // mb
    ur, ir, mask = problem.holdout_rows(hold[0], hold[1])
    say("main.device.data", train=u.shape[0], holdout=hold[0].shape[0],
        users=U0.shape[0], items=V0.shape[0],
        rows_per_block=f"{problem.rows_per_block_u}/"
                       f"{problem.rows_per_block_v}",
        block_nnz=b, n_mb=n_mb, max_pad_ratio=problem.max_pad_ratio,
        generation_wall_s=gen_s, blocking_wall_s=block_s,
        blocking_warm_wall_s=block_warm_s, init_wall_s=init_s)
    ids_u = problem.to_id_indices()[0].ids
    args = (problem.su, problem.si, problem.sv, problem.sw, problem.omega_u,
            problem.omega_v, problem.icu, problem.icv)
    sched = schedule_from_name(cfg.lr_schedule, cfg.lambda_)
    runs, final, sweeps = {}, {}, {}
    for dtype in ("float32", "bfloat16"):
        dcfg = dataclasses.replace(cfg, factor_dtype=dtype)
        solver = DSGD(dcfg)
        solver.evaluator = DeviceHoldoutEval(ur, ir, hold[2], mask)
        half = dtype == "bfloat16"
        ckpt = TimedCheckpoints(os.path.join(scratch, dtype)) if half \
            else None
        torch.cuda.synchronize()
        cuda_sgd.reset_launch_counts()
        t0 = time.perf_counter()
        model = solver.fit_device(u, i, r, nu, ni, num_blocks=K,
                                  checkpoint_manager=ckpt,
                                  checkpoint_every=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(cuda_sgd.LAUNCHES)
        curve = solver.evaluator.rmse
        # the replay: the plain twin on the card, same layout and init
        a, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        Ur, Vr = cuda_sgd.dsgd_train_reference(
            U0.to(model.U.dtype), V0.to(model.U.dtype), *args,
            lr=cfg.learning_rate, lam=cfg.lambda_, minibatch=mb,
            num_blocks=K, iterations=cfg.iterations, schedule=sched)
        e.record()
        e.synchronize()
        rmse_plain = solver.evaluator.of(Ur, Vr)
        sweeps[dtype] = solver.segment_ms
        beside = ({} if not half else dict(
            f32_sweep_ms=sweeps["float32"],
            bf16_over_f32=sum(sweeps["bfloat16"]) / sum(sweeps["float32"])))
        say(f"main.device.{dtype}", wall_s=wall, plan_build_s=solver.plan_s,
            sweep_ms=solver.segment_ms, **beside,
            ratings_per_s=problem.nnz * len(solver.segment_ms)
            / (sum(solver.segment_ms) / 1e3),
            rmse_per_sweep=curve, launches=launches,
            plain_twin_ms=a.elapsed_time(e), rmse_plain_twin=rmse_plain)
        if model.U.dtype != dcfg.storage_dtype():
            raise AssertionError(f"fit_device tables are {model.U.dtype}")
        if not np.array_equal(model.users.ids, ids_u):
            raise AssertionError("fit_device blocked another layout")
        if not all(math.isfinite(x) for x in curve) or len(curve) != 3:
            raise AssertionError(f"{dtype} holdout RMSE curve {curve}")
        if not all(y < x for x, y in zip(curve, curve[1:])):
            raise AssertionError(f"{dtype} holdout RMSE did not fall every "
                                 f"sweep: {curve}")
        check_launches(launches, n_mb, cfg.iterations)
        bar = 1e-3 if half else 1e-4
        if not abs(rmse_plain - curve[-1]) <= bar:
            raise AssertionError(f"{dtype}: plain twin RMSE {rmse_plain} vs "
                                 f"fit_device {curve[-1]}: beyond {bar}")
        runs[f"fit_device_{dtype}"] = launches
        final[dtype] = curve[-1]
        if not half:  # the uninstrumented reference of [obs.train]
            f32 = dict(U=model.U, V=model.V, segment_ms=solver.segment_ms)
        if half:
            check_resume("fit_device", ckpt, model, lambda: DSGD(
                dcfg).fit_device(u, i, r, nu, ni, num_blocks=K,
                                 checkpoint_manager=ckpt, checkpoint_every=1,
                                 resume=True))
    gap = abs(final["bfloat16"] - final["float32"]) / final["float32"]
    say("main.device", rmse_f32=final["float32"], rmse_bf16=final["bfloat16"],
        bf16_relative_gap=gap, target=RMSE_TARGET)
    if not gap <= 0.05:
        raise AssertionError(f"bf16 RMSE {final['bfloat16']} is not within "
                             f"5% of f32 {final['float32']}")
    obs_data = dict(train=(u, i, r), nu=nu, ni=ni, hold=hold,
                    holdout_rows=(ur, ir, mask), args=args, **f32)
    return runs, (U0, V0), obs_data


# -- [obs.train]: DSGD.fit_device with observability on ------------------


class WalledDSGD(DSGD):
    """``DSGD`` with a host stopwatch around each segment's training call,
    the card drained on both ends (outside obs: the uninstrumented steady
    sweep's wall)."""

    def _train_fn(self, args, k):
        train = super()._train_fn(args, k)
        self.walls = []

        def walled(U, V, *, iterations, t0):
            torch.cuda.synchronize()
            t_a = time.perf_counter()
            out = train(U, V, iterations=iterations, t0=t0)
            torch.cuda.synchronize()
            self.walls.append(time.perf_counter() - t_a)
            return out

        return walled


class CountingClock:
    """Stands in for the ``time`` module inside obs: counts clock reads."""

    def __init__(self):
        self.reads = 0

    def perf_counter(self):
        self.reads += 1
        return time.perf_counter()

    def time(self):
        self.reads += 1
        return time.time()


PROFILE_MARGIN_S = 0.25  # profiler window open before / after a sweep
# device records the profiled sweep is framed with, on each side: a capture
# may lose records at its edges (one H100 run saw the first 10 of a sweep
# go missing with a 0.02 s margin), so the edges hold these and not the sweep
PROFILE_EDGE_LAUNCHES = 64


def device_intervals(trace_path):
    """(start µs, end µs, name) of the device intervals in a profiler trace
    (Chrome-trace categories ``kernel``, ``gpu_memcpy``, ``gpu_memset``),
    by start."""
    with open(trace_path) as f:
        doc = json.load(f)
    return sorted((e["ts"], e["ts"] + e.get("dur", 0.0), e.get("name", ""))
                  for e in doc["traceEvents"]
                  if e.get("ph") == "X"
                  and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))


def device_busy(trace_path, around=None):
    """(busy ms, window ms, intervals) of the card in a profiler trace:
    the union of its device intervals over the window from the first
    one's start to the last one's end; idle share = 1 − busy / window (the
    card waiting on the host's launches). With ``around`` (names), the
    window runs from the first interval whose name holds one of them to
    the last such one's end, and only intervals inside it count: the
    capture's edge records stay out."""
    named = device_intervals(trace_path)
    if around:
        hits = [(a, b) for a, b, name in named
                if any(n in name for n in around)]
        if hits:
            lo, hi = hits[0][0], max(b for _, b in hits)
            named = [x for x in named if x[0] >= lo and x[1] <= hi]
    iv = [(a, b) for a, b, _ in named]
    if not iv:
        raise AssertionError("the profiler trace holds no device interval")
    busy, (lo, hi) = 0.0, iv[0]
    for a, b in iv[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    window = max(b for _, b in iv) - iv[0][0]
    return busy / 1e3, window / 1e3, len(iv)


def profiled_kernels(prof):
    """Device time (ms) and count per op of a ``torch.profiler`` run,
    largest device time first."""
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((e.key, e.count, us / 1e3))
    return sorted(rows, key=lambda r: -r[2])


def phase_obs_train(cfg, scratch, data):
    """``[obs.train]``: the f32 ``fit_device`` of [main.device] again with
    observability on (registry, tracer, journal, the library build hook,
    introspection at 0.25 s, the transfer guard in ``log`` mode), a halting
    ``TrainingWatchdog`` and an ``OnlineEvaluator`` on the holdout, a
    snapshot per sweep. Its tables must equal the uninstrumented fit's
    bit for bit; 3 timed segments (compile, execute, execute); a valid
    Chrome trace; health OK. Then, after a throwaway capture, one steady
    sweep under the profiler (both step kernels, 96 launches each, with
    ``PROFILE_MARGIN_S`` of window and ``PROFILE_EDGE_LAUNCHES`` other
    kernels on each side; the card's busy and idle share over the
    sweep), the k = 1 divergence tripping the watchdog (no snapshot of
    the poisoned sweep, health CRITICAL), and after ``obs.disable()`` an
    uninstrumented fit whose obs reads no clock and waits on nothing.
    Returns the instrumented fit's launch counts and its implicit
    transfers by site."""
    from large_scale_recommendation_tpu_torch.obs import instrument
    from large_scale_recommendation_tpu_torch.obs import trace as obs_trace
    from large_scale_recommendation_tpu_torch.obs.introspect import (
        profile_trace,
    )

    phase_t0 = time.perf_counter()
    u, i, r = data["train"]
    nu, ni = data["nu"], data["ni"]
    args = data["args"]
    n_mb = args[0].shape[-1] // cfg.minibatch_size
    fit = dict(num_blocks=K, checkpoint_every=1)

    # the uninstrumented steady sweep: obs off, a stopwatch outside it
    off = WalledDSGD(cfg)
    m_off = off.fit_device(u, i, r, nu, ni, **fit)
    if not (torch.equal(m_off.U, data["U"]) and torch.equal(m_off.V,
                                                          data["V"])):
        raise AssertionError("a rerun of the f32 fit_device differs")

    # -- 1. the instrumented fit
    reg, tracer = obs.enable()
    obs.set_events(obs.EventJournal())
    tracer.install_build_hook(reg)
    intro = obs.enable_introspection(interval_s=0.25)
    ledger = obs.enable_transfers(guard="log")
    watchdog = obs.TrainingWatchdog(policy="halt")
    ur, ir, mask = data["holdout_rows"]
    keep = mask > 0
    evaluator = obs.OnlineEvaluator(source="obs.train")
    evaluator.set_offline_holdout(ur[keep].cpu().numpy(),
                                  ir[keep].cpu().numpy(),
                                  data["hold"][2][keep].cpu().numpy())
    ckpt = CheckpointManager(os.path.join(scratch, "obs_train"), keep=3)
    monitor = obs.HealthMonitor()
    monitor.watch_watchdog(watchdog)
    monitor.watch_transfers(ledger)
    monitor.watch_checkpoints(ckpt, degraded_after_s=3600.0)
    solver = DSGD(cfg)
    solver.watchdog, solver.evaluator = watchdog, evaluator
    cuda_sgd.reset_launch_counts()
    model, wall_on = timed(lambda: solver.fit_device(
        u, i, r, nu, ni, checkpoint_manager=ckpt, **fit))
    launches = dict(cuda_sgd.LAUNCHES)
    check_launches(launches, n_mb, cfg.iterations)
    equal = (torch.equal(model.U, data["U"])
             and torch.equal(model.V, data["V"]))
    spans = [e for e in tracer.events() if e["name"] == "train/dsgd"]
    cats = [e["cat"] for e in spans]
    segments = reg.counter("train_segments_total", model="dsgd").value
    obs.validate_chrome_trace(tracer.chrome_trace())
    health = monitor.run()
    say("obs.train", tables_equal_uninstrumented=equal, segments=segments,
        span_categories=cats, chrome_trace_valid=True,
        events=[e["kind"] for e in obs.get_events().events()],
        watchdog_tripped=watchdog.tripped, health=health["status"],
        eval=evaluator.last_metrics, fit_wall_s=wall_on,
        checkpoints=ckpt.steps(), launches=launches)
    if not equal:
        raise AssertionError("instrumented fit_device tables differ from "
                             "the uninstrumented fit's")
    if segments != 3 or cats != ["compile", "execute", "execute"]:
        raise AssertionError(f"segments {segments}, spans {cats}")
    if watchdog.tripped or health["status"] != obs.OK:
        raise AssertionError(f"health {health}")

    # -- 2. the numbers
    def mean(xs):
        return sum(xs) / len(xs)

    timer_ms = [e["dur"] / 1e3 for e in spans]
    steady = slice(1, None)  # the segments after the first (one sweep each)
    on_ms = mean(timer_ms[steady])
    dev_on = mean(solver.segment_ms[steady])
    off_ms = mean(off.walls[steady]) * 1e3
    dev_off = mean(off.segment_ms[steady])
    rows = [row for row in intro.roofline()["rows"]
            if row["module"] == "dsgd_sweep"
            and row["key"].startswith("train_segment/dsgd_device_segment")]
    if len(rows) != 1:
        raise AssertionError(f"roofline rows of the segment key: {rows}")
    roof = rows[0]
    sample, sample_s = timed(intro.sample_device_memory)
    card = sample["devices"][0]["stats"] or {}
    tables = model.U.nbytes + model.V.nbytes
    implicit_by_site = ledger.snapshot()["implicit_by_site"]
    implicit = implicit_by_site.get("dsgd.fit", 0)
    builds = {dict(h.labels)["library"]: {"loads": h.count, "s": h.sum}
              for h in reg.find("kernel_build_s")}
    say("obs.train.numbers", steady_timer_wall_ms=timer_ms[steady],
        steady_segment_ms=solver.segment_ms[steady],
        timer_over_segment_ms=on_ms - dev_on,
        steady_sweep_ms_instrumented=on_ms,
        steady_sweep_ms_uninstrumented=off_ms,
        instrumented_over_uninstrumented=on_ms / off_ms,
        device_segment_ms_on=dev_on, device_segment_ms_off=dev_off,
        roofline_key=roof["key"], achieved_gbs=roof["achieved_gbs"],
        pct_of_hbm_peak=roof["pct_of_hbm_peak"],
        hbm_peak_gbs=intro.peaks()[0],
        record_bytes_per_exec=roof["xla_bytes_accessed"],
        model_bytes_per_exec=roof["model_bytes_per_exec"],
        record_over_model_bytes=roof["xla_vs_model_bytes"],
        memory_supported=sample["supported"], memory=card,
        live_tensors=sample["live_arrays"], memory_sample_s=sample_s,
        table_bytes=tables, implicit_transfers_dsgd_fit=implicit,
        kernel_build_s=builds)
    if not roof["pct_of_hbm_peak"] or roof["pct_of_hbm_peak"] > 100.0:
        raise AssertionError(f"pct_of_hbm_peak {roof['pct_of_hbm_peak']}")
    if implicit != 0:  # the fit passes its plan: rows checked on the host
        raise AssertionError(f"{implicit} implicit transfers under the "
                             "dsgd.fit guard")
    if not sample["supported"] or card.get("bytes_in_use", 0) < tables:
        raise AssertionError(f"device memory sample {sample['devices']}")

    # -- 2b. the same comparison as 5 interleaved pairs (min of each side):
    # the single pair above is one reading of each and crossed its bar once
    def pair_fit(instrumented):
        if instrumented:
            s = DSGD(cfg)
            s.watchdog = obs.TrainingWatchdog(policy="halt")
            s.evaluator = evaluator
            n0 = len(tracer.events())
            s.fit_device(u, i, r, nu, ni, **fit)
            torch.cuda.synchronize()
            walls = [e["dur"] / 1e3 for e in tracer.events()[n0:]
                     if e["name"] == "train/dsgd"][steady]
            return mean(walls)
        # every plane off for this fit (they bind when a fit starts)
        saved = (obs.get_registry(), obs.get_tracer(), obs.get_events(),
                 obs.get_introspector(), obs.get_transfers())
        intro.stop()
        obs.set_registry(obs.NullRegistry())
        obs.set_tracer(obs.NullTracer())
        obs.set_events(None)
        obs.set_introspector(None)
        obs.set_transfers(None)
        try:
            s = WalledDSGD(cfg)
            s.fit_device(u, i, r, nu, ni, **fit)
        finally:
            obs.set_registry(saved[0])
            obs.set_tracer(saved[1])
            obs.set_events(saved[2])
            obs.set_introspector(saved[3])
            obs.set_transfers(saved[4])
            intro.start(0.25)
        return mean(s.walls[steady]) * 1e3

    pairs_on, pairs_off = [], []
    for _ in range(5):  # on, off, on, off, ...
        pairs_on.append(pair_fit(True))
        pairs_off.append(pair_fit(False))
    say("obs.train.pairs", runs_each=len(pairs_on),
        steady_sweep_ms_instrumented=pairs_on,
        steady_sweep_ms_uninstrumented=pairs_off,
        min_instrumented_over_min_uninstrumented=min(pairs_on)
        / min(pairs_off),
        single_pair_instrumented_over_uninstrumented=on_ms / off_ms)

    # -- 3. one steady sweep under the profiler
    su, si, sv, sw, ou, ov, icu, icv = args
    sched = schedule_from_name(cfg.lr_schedule, cfg.lambda_)

    def sweep():
        return cuda_sgd.dsgd_train_cuda(
            model.U, model.V, *args, lr=cfg.learning_rate, lam=cfg.lambda_,
            minibatch=cfg.minibatch_size, num_blocks=K, iterations=1,
            schedule=sched, t0=cfg.iterations, plan=solver._plan)

    def step_counts(prof):
        ops = profiled_kernels(prof)
        return ops, {name: sum(c for key, c, _ in ops if name in key)
                     for name in ("sgd_item_rows_kernel",
                                  "sgd_user_rows_kernel")}

    edge = torch.zeros(1024, device=model.U.device)

    def edge_records():  # device records that frame the profiled sweep
        for _ in range(PROFILE_EDGE_LAUNCHES):
            edge.add_(1.0)
        torch.cuda.synchronize()

    sweep()  # warm
    torch.cuda.synchronize()
    # This is the process's first capture with CUDA activity: a throwaway
    # one pays CUPTI's one-time start. A capture may lose the records at
    # its edges (runs on an H100 saw 87 and 92 of 96, the sweep's first
    # launches gone), so the measured one frames the sweep with
    # PROFILE_MARGIN_S of window and PROFILE_EDGE_LAUNCHES other kernels
    # on each side, and counts and times only what lies between them.
    with profile_trace(os.path.join(scratch, "obs_profile_warm")) as prof:
        timed(sweep)
    warm_counts = step_counts(prof)[1]
    prof_dir = os.path.join(scratch, "obs_profile")
    with profile_trace(prof_dir) as prof:
        edge_records()
        time.sleep(PROFILE_MARGIN_S)
        _, prof_wall = timed(sweep)
        time.sleep(PROFILE_MARGIN_S)
        edge_records()
    ops, counts = step_counts(prof)
    trace = os.path.join(prof_dir, TRACE_FILE)
    busy_ms, window_ms, n_iv = device_busy(
        trace, around=("sgd_item_rows_kernel", "sgd_user_rows_kernel",
                       "Memcpy DtoD"))
    edge_seen = len(device_intervals(trace)) - n_iv
    say("obs.train.profile", top_device_ops=[
        (key[:48], c, round(ms, 4)) for key, c, ms in ops[:6]],
        step_kernel_launches=counts,
        warm_capture_step_kernel_launches=warm_counts,
        edge_launches=2 * PROFILE_EDGE_LAUNCHES, edge_records=edge_seen,
        sweep_wall_ms=prof_wall * 1e3,
        device_busy_ms=busy_ms, device_window_ms=window_ms,
        device_intervals=n_iv, device_busy_share=busy_ms / window_ms,
        device_idle_share=1.0 - busy_ms / window_ms,
        busy_over_host_wall=busy_ms / (prof_wall * 1e3),
        how="union of the trace's kernel/memcpy/memset intervals over the "
            "window from the sweep's first device interval's start to its "
            "last one's end")
    if counts != {"sgd_item_rows_kernel": n_mb * K,
                  "sgd_user_rows_kernel": n_mb * K}:
        raise AssertionError(f"profiled step-kernel launches {counts}, "
                             f"expected {n_mb * K} each (warm capture "
                             f"{warm_counts}, {n_iv} device intervals "
                             f"over {window_ms} ms, {edge_seen} of "
                             f"{2 * PROFILE_EDGE_LAUNCHES} edge records)")

    # -- 4. the k = 1 divergence trips the watchdog
    trip = obs.TrainingWatchdog(policy="halt")
    trip_monitor = obs.HealthMonitor()
    trip_monitor.watch_watchdog(trip)
    poisoned = CheckpointManager(os.path.join(scratch, "obs_diverge"))
    diverging = DSGD(cfg)
    diverging.watchdog = trip
    try:
        diverging.fit_device(u, i, r, nu, ni, num_blocks=1,
                             checkpoint_manager=poisoned,
                             checkpoint_every=1)
    except obs.TrainingDivergedError as e:
        error = repr(e)[:160]
    else:
        raise AssertionError("the k = 1 divergence did not trip the "
                             "watchdog")
    report = trip_monitor.run()
    state = reg.gauge("watchdog_state").value
    say("obs.train.diverge", error=error, snapshots=poisoned.steps(),
        health=report["status"],
        training_check=report["checks"]["training"]["status"],
        watchdog_state=state,
        trip_events=[e["kind"] for e in obs.get_events().events()
                     if e["kind"].startswith(("watchdog", "health"))])
    if (poisoned.steps() or report["status"] != obs.CRITICAL
            or report["checks"]["training"]["status"] != obs.CRITICAL
            or state != 2):
        raise AssertionError(f"divergence: snapshots {poisoned.steps()}, "
                             f"health {report}, watchdog_state {state}")

    # -- 5. disabled: obs reads no clock and waits on nothing
    obs.disable()
    clock, blocks = CountingClock(), []

    def counting_block(x):
        blocks.append(x)

    saved = (instrument.time, obs_trace.time, instrument._block,
             obs_trace._block)
    instrument.time = obs_trace.time = clock
    instrument._block = obs_trace._block = counting_block
    try:
        quiet = DSGD(cfg)
        m_quiet = quiet.fit_device(u, i, r, nu, ni, **fit)
        torch.cuda.synchronize()
    finally:
        (instrument.time, obs_trace.time, instrument._block,
         obs_trace._block) = saved
    say("obs.train.disabled", obs_clock_reads=clock.reads,
        obs_blocks=len(blocks),
        sync_debug_mode=torch.cuda.get_sync_debug_mode(),
        steady_segment_ms=quiet.segment_ms[steady],
        tables_equal=torch.equal(m_quiet.U, data["U"]),
        phase_wall_s=time.perf_counter() - phase_t0)
    if clock.reads or blocks or torch.cuda.get_sync_debug_mode() != 0:
        raise AssertionError(f"disabled obs read the clock {clock.reads} "
                             f"times and blocked {len(blocks)} times")
    return launches, implicit_by_site


ROUTES_SCRAPED = ("/metrics", "/healthz", "/seriesz", "/rooflinez",
                  "/transferz")


class Scraper(threading.Thread):
    """Scrapes ``routes`` of ``url`` in turn until stopped, logging each
    scrape's (route, start, end, status) and keeping each route's last
    body."""

    def __init__(self, url, routes=ROUTES_SCRAPED):
        super().__init__(name="chip-smoke-scraper", daemon=True)
        self.url, self.routes = url, routes
        self.log, self.bodies = [], {}
        self.halt = threading.Event()

    def run(self):
        while not self.halt.is_set():
            for route in self.routes:
                t0 = time.perf_counter()
                code, body = http_get(self.url + route, timeout=5.0)
                self.log.append((route, t0, time.perf_counter(), code))
                self.bodies[route] = body

    def rounds(self):
        return min(sum(1 for e in self.log if e[0] == r)
                   for r in self.routes)


def bundle_bytes(path):
    return sum(os.path.getsize(os.path.join(root, n))
               for root, _, names in os.walk(path) for n in names)


def phase_obs_recorder(cfg, scratch, data, smi, implicit_before):
    """``[obs.recorder]``: [obs.train]'s f32 ``fit_device`` with the flight
    recorder sampling every 0.25 s beside introspection and the transfer
    guard, a ``HealthMonitor`` (watchdog, device memory, quality) behind
    an ``ObsServer`` that a second thread scrapes while the fit runs.
    Checks: tables bit-equal to the uninstrumented fit's; every scrape
    200; ``/metrics`` parses; ``/rooflinez`` holds the step pair's row;
    ``/seriesz`` the card's memory series and ``eval_rmse`` (≥ 3 points);
    the guard's implicit transfers equal [obs.train]'s. Then the
    recorder's cost on the steady sweep (interleaved against obs on with
    the recorder stopped, min of 5), one ``sample()``'s wall; the k = 1
    divergence freezing a valid bundle from the card (``/healthz`` 503
    after it); ``/profilez`` 200 with a second capture 409; the fleet view
    over this server and a second one. Returns the scraped fit's launch
    counts."""
    from large_scale_recommendation_tpu_torch.obs.recorder import (
        series_key,
        validate_bundle,
    )

    phase_t0 = time.perf_counter()
    u, i, r = data["train"]
    nu, ni = data["nu"], data["ni"]
    n_mb = data["args"][0].shape[-1] // cfg.minibatch_size
    kind = "dsgd_device_segment"

    # -- 1. the planes
    reg, tracer = obs.enable()
    bundle_dir = os.path.join(scratch, "obs_bundles")
    recorder, journal = obs.enable_flight_recorder(interval_s=0.25,
                                                   bundle_dir=bundle_dir)
    intro = obs.enable_introspection(interval_s=0.25)
    ledger = obs.enable_transfers(guard="log")
    watchdog = obs.TrainingWatchdog(policy="halt")
    ur, ir, mask = data["holdout_rows"]
    keep = mask > 0
    evaluator = obs.OnlineEvaluator(source="obs.recorder")
    evaluator.set_offline_holdout(ur[keep].cpu().numpy(),
                                  ir[keep].cpu().numpy(),
                                  data["hold"][2][keep].cpu().numpy())
    monitor = obs.HealthMonitor()
    monitor.watch_watchdog(watchdog)
    monitor.watch_device_memory(recorder)
    monitor.watch_quality(recorder, source=kind, k=evaluator.k)
    server = obs.ObsServer(monitor=monitor,
                           profile_dir=os.path.join(scratch, "profilez"))
    server.start()
    if not (recorder.running and intro.running and server.running):
        raise AssertionError("the recorder, sampler or server did not start")
    dumps = []  # (trigger, host seconds) of every bundle the recorder wrote
    real_dump = recorder.dump

    def timed_dump(trigger="manual", **kw):
        t0 = time.perf_counter()
        out = real_dump(trigger=trigger, **kw)
        dumps.append((trigger, time.perf_counter() - t0))
        return out

    recorder.dump = timed_dump

    # -- 2. the fit, scraped while it runs
    scraper = Scraper(server.url)
    scraper.start()
    while scraper.rounds() < 1:  # the scraper is in its loop
        time.sleep(0.01)
    ckpt = CheckpointManager(os.path.join(scratch, "obs_recorder"), keep=3)
    solver = DSGD(cfg)
    solver.watchdog, solver.evaluator = watchdog, evaluator
    cuda_sgd.reset_launch_counts()
    torch.cuda.synchronize()
    fit_t0 = time.perf_counter()
    model = solver.fit_device(u, i, r, nu, ni, num_blocks=K,
                              checkpoint_manager=ckpt, checkpoint_every=1)
    torch.cuda.synchronize()
    fit_t1 = time.perf_counter()
    launches = dict(cuda_sgd.LAUNCHES)
    check_launches(launches, n_mb, cfg.iterations)
    implicit = ledger.snapshot()["implicit_by_site"]
    during = {rt: sum(1 for e in scraper.log
                      if e[0] == rt and fit_t0 <= e[1] < fit_t1)
              for rt in ROUTES_SCRAPED}
    rmse_key = series_key("eval_rmse", {"source": kind})
    mem_key = series_key("device_bytes_in_use", {"device": "cuda:0"})
    deadline = time.perf_counter() + 10.0
    while (min(len(recorder.series_values(k)) for k in (rmse_key, mem_key))
           < 3 and time.perf_counter() < deadline):
        time.sleep(0.05)  # the sampler's next ticks
    start_round = scraper.rounds()
    while scraper.rounds() < start_round + 1:  # one round after the fit
        time.sleep(0.01)
    scraper.halt.set()
    scraper.join(timeout=30)
    equal = (torch.equal(model.U, data["U"])
             and torch.equal(model.V, data["V"]))
    codes = collections.Counter((e[0], e[3]) for e in scraper.log)
    prom = obs.parse_prometheus(scraper.bodies["/metrics"])
    roof_rows = [row for row in json.loads(
        scraper.bodies["/rooflinez"])["rows"]
        if row["module"] == "dsgd_sweep"
        and row["key"].startswith(f"train_segment/{kind}")]
    series = json.loads(scraper.bodies["/seriesz"])["series"]
    metrics_walls = sorted((e[2] - e[1]) * 1e3 for e in scraper.log
                           if e[0] == "/metrics"
                           and fit_t0 <= e[1] < fit_t1)
    say("obs.recorder", card=smi, tables_equal_uninstrumented=equal,
        fit_wall_s=fit_t1 - fit_t0, scrapes_during_fit=during,
        scrape_codes={f"{rt} {c}": n for (rt, c), n in codes.items()},
        metrics_samples=len(prom), rooflinez_rows=len(roof_rows),
        seriesz_points={k: series.get(k, {}).get("n", 0)
                        for k in (mem_key, rmse_key)},
        series_count=len(series),
        implicit_by_site=implicit, implicit_obs_train=implicit_before,
        metrics_scrape_ms_during_fit={
            "n": len(metrics_walls), "min": metrics_walls[0],
            "p50": metrics_walls[len(metrics_walls) // 2],
            "max": metrics_walls[-1]} if metrics_walls else None,
        launches=launches)
    if scraper.is_alive() or not equal:
        raise AssertionError("the scraped fit's tables differ from the "
                             "uninstrumented fit's, or the scraper hung")
    if any(c != 200 for (_, c) in codes) or min(during.values()) < 2:
        raise AssertionError(f"scrapes {dict(codes)}, during the fit "
                             f"{during}")
    if len(roof_rows) != 1 or not prom:
        raise AssertionError(f"/rooflinez rows {roof_rows}, /metrics "
                             f"samples {len(prom)}")
    if (series.get(mem_key, {}).get("n", 0) < 3
            or series.get(rmse_key, {}).get("n", 0) < 3):
        raise AssertionError(f"/seriesz lacks {mem_key} or {rmse_key} "
                             f"with 3 points: {sorted(series)[:20]}")
    if implicit != implicit_before:
        raise AssertionError(f"implicit transfers {implicit} with the "
                             f"recorder, {implicit_before} without")

    # -- 3. the recorder's cost on the steady sweep
    def steady_fit():
        n0 = len(tracer.events())
        s = DSGD(cfg)
        s.fit_device(u, i, r, nu, ni, num_blocks=K, checkpoint_every=1)
        torch.cuda.synchronize()
        spans = [e["dur"] / 1e3 for e in tracer.events()[n0:]
                 if e["name"] == "train/dsgd" and e["cat"] == "execute"]
        return (sum(spans) / len(spans),
                sum(s.segment_ms[1:]) / len(s.segment_ms[1:]))

    on, off = [], []
    for _ in range(5):  # on, off, on, off, ...
        recorder.start(0.25)
        on.append(steady_fit())
        recorder.stop()
        off.append(steady_fit())
    recorder.start(0.25)
    t0 = time.perf_counter()
    touched = recorder.sample()
    sample_s = time.perf_counter() - t0
    timer_on, seg_on = min(w for w, _ in on), min(s for _, s in on)
    timer_off, seg_off = min(w for w, _ in off), min(s for _, s in off)
    say("obs.recorder.cost", card=smi, runs_each=len(on),
        timer_wall_ms_recorder_on=[w for w, _ in on],
        timer_wall_ms_recorder_off=[w for w, _ in off],
        segment_ms_recorder_on=[s for _, s in on],
        segment_ms_recorder_off=[s for _, s in off],
        min_timer_wall_ms=[timer_on, timer_off],
        min_segment_ms=[seg_on, seg_off],
        timer_on_over_off=timer_on / timer_off,
        segment_on_over_off=seg_on / seg_off,
        sample_wall_ms=sample_s * 1e3, sample_series=touched,
        series_count=len(recorder.series_names()),
        recorder_samples=recorder.samples, interval_s=recorder.interval_s)

    # -- 4. the k = 1 divergence freezes a bundle from the card
    trip = obs.TrainingWatchdog(policy="halt")
    monitor.watch_watchdog(trip)  # replaces the fit's "training" check
    diverging = DSGD(cfg)
    diverging.watchdog = trip
    try:
        diverging.fit_device(u, i, r, nu, ni, num_blocks=1)
    except obs.TrainingDivergedError:
        pass
    else:
        raise AssertionError("the k = 1 divergence did not trip")
    path = trip.last_bundle
    if path is None or not os.path.isdir(path):
        raise AssertionError(f"no bundle after the trip: {path!r} "
                             f"({recorder.last_dump_error})")
    manifest = validate_bundle(path)
    with open(os.path.join(path, "device_memory.json")) as f:
        mem = json.load(f)
    stats = mem["devices"][0]["stats"] or {}
    limit = torch.cuda.mem_get_info(0)[1]
    code, _ = http_get(server.url + "/healthz", timeout=5.0)
    health_bundles = [p for p in sorted(os.listdir(bundle_dir))
                      if p.startswith("bundle_health_critical")]
    say("obs.recorder.trip", card=smi, bundle=os.path.basename(path),
        trigger=manifest["trigger"], reason=manifest["detail"].get("reason"),
        counts=manifest["counts"], bundle_bytes=bundle_bytes(path),
        write_wall_ms=[(t, s * 1e3) for t, s in dumps],
        memory_supported=mem["supported"], bytes_limit=stats.get(
            "bytes_limit"), card_limit=limit,
        bytes_in_use=stats.get("bytes_in_use"),
        live_tensor_bytes=(mem.get("live_arrays") or {}).get("bytes"),
        healthz_after=code, health_bundles=health_bundles)
    if (manifest["trigger"] != "watchdog_trip"
            or manifest["detail"].get("reason") != trip.reason):
        raise AssertionError(f"bundle manifest {manifest}")
    if not mem["supported"] or stats.get("bytes_limit") != limit:
        raise AssertionError(f"device_memory.json {mem}")
    if code == 200:
        raise AssertionError("/healthz answers 200 after the trip")

    # -- 5. /profilez: a capture, and a second one refused
    got = {}
    capture = threading.Thread(target=lambda: got.setdefault(
        "first", http_get(server.url + "/profilez?seconds=1",
                          timeout=60.0)))
    capture.start()
    time.sleep(0.3)
    second = http_get(server.url + "/profilez?seconds=1", timeout=60.0)
    for _ in range(3):  # kernels for the capture to see
        DSGD(cfg).fit_device(u, i, r, nu, ni, num_blocks=K)
    capture.join(timeout=120)
    if capture.is_alive() or "first" not in got:
        raise AssertionError("the /profilez capture hung")
    code1, body1 = got["first"]
    doc = json.loads(body1) if code1 == 200 else {}
    cats = collections.Counter()
    if TRACE_FILE in doc.get("files", []):
        with open(os.path.join(doc["dir"], TRACE_FILE)) as f:
            cats.update(e.get("cat") for e in json.load(f)["traceEvents"])
    say("obs.recorder.profilez", card=smi, first=code1, second=second[0],
        files=doc.get("files"), seconds=doc.get("seconds"),
        trace_kernel_events=cats.get("kernel", 0),
        trace_cpu_ops=cats.get("cpu_op", 0))
    if code1 != 200 or TRACE_FILE not in doc.get("files", []) \
            or second[0] != 409 or not cats.get("kernel") \
            or not cats.get("cpu_op"):
        raise AssertionError(f"/profilez answered {code1} {body1[:200]} "
                             f"then {second}")

    # -- 6. the fleet view over this server and a second one
    reg2 = obs.MetricsRegistry()
    reg2.counter("fleet_probe_total").inc()
    other = obs.ObsServer(registry=reg2, tracer=obs.Tracer(),
                          monitor=obs.HealthMonitor(registry=reg2)).start()
    fleet = obs.FleetServer(obs.FleetAggregator(
        [server.url, other.url], timeout_s=5.0)).start()
    try:
        fz_code, fz = http_get(fleet.url + "/fleetz", timeout=30.0)
        fh_code, fh = http_get(fleet.url + "/healthz", timeout=30.0)
    finally:
        fleet.stop()
        other.stop()
    fz, fh = json.loads(fz), json.loads(fh)
    hosts = {lb.get("host") for _, lb, _ in
             obs.parse_prometheus(fz["prometheus"])}
    say("obs.recorder.fleet", fleetz=fz_code, hosts=sorted(hosts),
        target_status=[t["status"] for t in fz["targets"]],
        healthz=fh_code, status=fh["status"])
    if (fz_code != 200 or hosts != {f"127.0.0.1:{server.port}",
                                    f"127.0.0.1:{other.port}"}
            or fh_code != 503 or fh["status"] != obs.CRITICAL):
        raise AssertionError(f"fleet: /fleetz {fz_code} hosts {hosts}, "
                             f"/healthz {fh_code} {fh['status']}")

    server.stop()
    obs.disable()
    left = [t.name for t in threading.enumerate()
            if t.name in ("flight-recorder", "obs-introspect")
            or t.name.startswith(("obs-server", "fleet-server"))]
    say("obs.recorder.done", threads_left=left,
        phase_wall_s=time.perf_counter() - phase_t0)
    if left:
        raise AssertionError(f"threads left running: {left}")
    return launches


def topk_mismatches(ids, scores, ids_ref, scores_ref, tol=SCORE_TOL):
    """Tie-aware top-K comparison: scores must agree position by position
    within ``tol``; ids must be equal wherever a score stands more than
    2·tol apart from both neighbours (near-ties may swap between devices).
    Returns (max score difference, ids compared, ids that differ)."""
    diff = float(np.abs(scores - scores_ref).max())
    apart = np.ones(scores_ref.shape, bool)
    gap = np.abs(np.diff(scores_ref, axis=1)) > 2 * tol
    apart[:, 1:] &= gap
    apart[:, :-1] &= gap
    return diff, int(apart.sum()), int((ids[apart] != ids_ref[apart]).sum())


def phase_serve(model, cpu_model, train):
    """Top-K through ``MFModel.recommend`` on the trained ``fit`` model
    (bench.py:659-686: 16,384 users, k = 10, no exclusions), warmed on
    2,048 users; its bound is the f32 scoring matmul at the card's peak.
    Then the same call on the CPU for 256 users (tie-aware), and with
    ``train=`` exclusion no train item in 2,048 users' lists."""
    users = model.users.sorted_ids[:SERVE_USERS]
    n, n_items, rank = len(users), model.V.shape[0], model.rank
    model.recommend(users[:SERVE_WARM], k=SERVE_K)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids, scores = model.recommend(users, k=SERVE_K)  # numpy out: synced
    wall = time.perf_counter() - t0
    flops = 2 * n * n_items * rank
    nbytes = n * rank * 4 + n_items * rank * 4 + n * SERVE_K * 8
    bound_ms, bound_by = bound_of(nbytes, flops)
    if not (ids.shape == (n, SERVE_K) and (ids >= 0).all()
            and np.isfinite(scores).all()
            and (np.diff(scores, axis=1) <= 0).all()):
        raise AssertionError("recommend: malformed top-K lists")
    cpu_ids, cpu_scores = cpu_model.recommend(users[:256], k=SERVE_K)
    diff, compared, differ = topk_mismatches(ids[:256], scores[:256],
                                             cpu_ids, cpu_scores)
    if diff > SCORE_TOL * max(1.0, float(np.abs(cpu_scores).max())) \
            or differ:
        raise AssertionError(f"recommend card vs CPU: score diff {diff}, "
                             f"{differ} of {compared} ids differ")
    sub = users[:SERVE_WARM]
    ex_ids, _ = model.recommend(sub, k=SERVE_K, train=train)
    leaked, mine = train_items_served(train, sub, ex_ids)
    if leaked or (ex_ids < 0).any():
        raise AssertionError(f"recommend(train=): {leaked} train items "
                             "served")
    # one 2,048-user chunk's device parts (CUDA events), beside the wall
    rows = torch.as_tensor(model.users.rows_for(users[:SERVE_WARM])[0],
                           device=model.device)
    Vt = model.V.float().T
    item_w = torch.zeros(n_items, device=model.device)
    scores_c = model.U[rows] @ Vt
    parts = {"matmul_ms": cuda_ms(lambda: model.U[rows] @ Vt, reps=10),
             "item_w_add_ms": cuda_ms(lambda: scores_c.add_(item_w), reps=10),
             "topk_ms": cuda_ms(lambda: torch.topk(scores_c, SERVE_K, dim=1),
                                reps=10)}
    chunks = -(-n // SERVE_WARM)
    say("serve", users=n, k=SERVE_K, item_rows=n_items, rank=rank,
        wall_s=wall, chunks=chunks, **{f"chunk_{k}": v for k, v in
                                       parts.items()},
        device_parts_share_of_wall=chunks * sum(parts.values()) / 1e3 / wall,
        users_per_s=n / wall, tflop=flops / 1e12,
        tflop_per_s=flops / wall / 1e12,
        share_of_f32_peak=flops / wall / F32_FLOP_PER_S,
        bound_ms=bound_ms, bound_by=bound_by,
        share_of_bound=bound_ms / 1e3 / wall,
        cpu_256_max_score_diff=diff, cpu_256_ids_compared=compared,
        cpu_256_ids_differ=differ, excluded_users=len(sub),
        train_pairs_of_them=mine, train_items_served=leaked)
    return bound_ms / 1e3 / wall


def train_items_served(train, users, ids):
    """(train pairs of ``users`` found in their served lists ``ids``, the
    number of train pairs those users have)."""
    tu, ti = train.users.astype(np.int64), train.items.astype(np.int64)
    mine = np.isin(tu, users)
    seen = tu[mine] * (1 << 32) + ti[mine]
    served = (np.repeat(users.astype(np.int64), ids.shape[1]) * (1 << 32)
              + ids.reshape(-1))
    return int(np.isin(served, seen).sum()), int(mine.sum())


def phase_eval(model, cpu_model, train, holdout):
    """HR@10 / NDCG@10 through ``MFModel.ranking_quality`` on 65,536
    holdout pairs with the train set excluded; the first 4,096 pairs also
    on the CPU at k = 10 and at k = 1,000 (where these random holdout
    draws do hit), within 1e-3 (one pair is 2.4e-4)."""
    hu, hi = holdout.users[:EVAL_PAIRS], holdout.items[:EVAL_PAIRS]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q = model.ranking_quality(hu, hi, k=SERVE_K, train=train)
    wall = time.perf_counter() - t0
    if not (0 < q["n"] <= len(hu) and 0 <= q["hr"] <= 1
            and 0 <= q["ndcg"] <= q["hr"]):
        raise AssertionError(f"ranking_quality: {q}")
    both = {}
    for k in (SERVE_K, 1000):
        sub = dict(eval_u=hu[:EVAL_CPU_PAIRS], eval_i=hi[:EVAL_CPU_PAIRS],
                   k=k, train=train)
        card, cpu = (model.ranking_quality(**sub),
                     cpu_model.ranking_quality(**sub))
        both.update({f"hr{k}_4096_card": card["hr"],
                     f"hr{k}_4096_cpu": cpu["hr"],
                     f"ndcg{k}_4096_card": card["ndcg"],
                     f"ndcg{k}_4096_cpu": cpu["ndcg"]})
        if not (abs(card["hr"] - cpu["hr"]) <= 1e-3
                and abs(card["ndcg"] - cpu["ndcg"]) <= 1e-3):
            raise AssertionError(f"ranking_quality@{k} card {card} vs "
                                 f"CPU {cpu}")
    say("eval", pairs=q["n"], k=SERVE_K, hr=q["hr"], ndcg=q["ndcg"],
        wall_s=wall, **both)


# -- the serving engine (no kernel of its own: torch ops on the card) -------

SERVE_REQ_MAX, SERVE_MAX_BATCH = 32, 1024  # scripts/serving_bench.py:382
# SERVING_r03.json's geometry and index (serving_bench.py:382-409)
TWO_STAGE = dict(num_users=20_000, num_items=1_048_576, rank=64,
                 n_centers=256, seed=0)
TWO_STAGE_CFG = dict(overfetch=4, n_clusters=512, n_probe=16,
                     kmeans_sample=65536, seed=0)
TWO_STAGE_REQUESTS, RECALL_USERS, RECALL_MIN = 400, 256, 0.95
BF16_SCORE_TOL = 2e-2  # tests/test_serving_engine.py:137
DELTA_ROWS, OVERLAP_CHUNKS = 1024, 8


def cut_requests(users, rng, req_max=SERVE_REQ_MAX):
    """``users`` cut in order into requests of 1..``req_max`` users."""
    out, i = [], 0
    while i < len(users):
        n = int(rng.integers(1, req_max + 1))
        out.append(users[i:i + n])
        i += n
    return out


def served(results):
    """Per-request (ids, scores) results stacked row-wise."""
    return (np.concatenate([r[0] for r in results]),
            np.concatenate([r[1] for r in results]))


def best_serve(eng, requests, reps=2):
    """A warm pass, then the best of ``reps`` passes of ``eng.serve``
    (results are host arrays: each pass is synchronized). Returns (the
    last pass's results, best users/s, every flush wall of the timed
    passes)."""
    eng.serve(requests)
    walls, flush = [], eng.flush

    def timed_flush(return_mask=False):
        t0 = time.perf_counter()
        out = flush(return_mask=return_mask)
        walls.append(time.perf_counter() - t0)
        return out

    eng.flush = timed_flush
    rows, best = sum(len(r) for r in requests), 0.0
    try:
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = eng.serve(requests)
            best = max(best, rows / (time.perf_counter() - t0))
    finally:
        del eng.flush  # the method again
    return out, best, walls


def ms_quantiles(walls):
    return {"flush_ms_p50": float(np.percentile(walls, 50)) * 1e3,
            "flush_ms_p99": float(np.percentile(walls, 99)) * 1e3}


def check_topk(label, ids, scores, ids_ref, scores_ref):
    """``topk_mismatches`` as a check; returns (diff, compared, differ)."""
    out = topk_mismatches(ids, scores, ids_ref, scores_ref)
    if out[0] > SCORE_TOL * max(1.0, float(np.abs(scores_ref).max())) \
            or out[2]:
        raise AssertionError(f"{label}: score diff {out[0]}, {out[2]} of "
                             f"{out[1]} ids differ")
    return out


def pipeline_overlap(eng, users):
    """The two-deep pipeline on one flush of ``OVERLAP_CHUNKS`` micro-batches
    of 1,024 rows, in parts: per micro-batch the host's staging (exclusion
    build, pinned copies, gather dispatch; host clock, no sync) and the
    device's scoring (CUDA events), beside the flush's synced wall, the
    part of it inside ``_serve_rows`` (the pipeline), and the wall of a
    one-micro-batch flush."""
    dev, cat = eng._device, eng._catalog
    n, reps = OVERLAP_CHUNKS, 3
    sub = users[:n * SERVE_MAX_BATCH]
    rows = eng.model.users.rows_for(sub)[0]
    host, device = [], []
    for i in range(n):
        cu = rows[i * SERVE_MAX_BATCH:(i + 1) * SERVE_MAX_BATCH]

        def stage():
            excl = tuple(topk.to_device(a, dev) for a in eng._build_excl(
                cu, len(cu)))
            return excl, eng._U.index_select(0, topk.to_device(cu, dev))

        stage()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            excl, U_chunk = stage()
        host.append((time.perf_counter() - t0) / reps * 1e3)
        torch.cuda.synchronize()
        device.append(cuda_ms(lambda: topk.topk_step(
            U_chunk, cat.V_sh, cat.w_sh, *excl, k_out=eng._k_out), reps=reps))
    eng.recommend(sub)
    flush_ms = timed(lambda: eng.recommend(sub))[1] * 1e3
    pipe_ms = timed(lambda: eng._serve_rows(rows))[1] * 1e3
    one = sub[:SERVE_MAX_BATCH]
    one_ms = timed(lambda: eng.recommend(one))[1] * 1e3
    return {"chunk_rows": SERVE_MAX_BATCH,
            "chunk_host_ms": host, "chunk_device_ms": device,
            "flush_1_chunk_ms": one_ms,
            "flush_1_serial_ms": host[0] + device[0],
            f"flush_{n}_chunks_ms": flush_ms,
            f"flush_{n}_pipeline_ms": pipe_ms,
            f"flush_{n}_serial_ms": sum(host) + sum(device),
            # two deep: micro-batch i's scoring hides under i+1's staging
            f"flush_{n}_overlapped_ms": host[0] + max(sum(host[1:]),
                                                      sum(device[:-1]))
            + device[-1]}


def check_bf16(model, requests, ids32, scores32):
    """The bf16 engine against the f32 one (test_bf16_catalog_parity's
    bound): scores within 2e-2 (rtol and atol) position by position, and
    the id sets equal except for users whose f32 10th and 11th scores lie
    within twice that of each other (where a swap at the boundary is
    within the bound)."""
    eng = ServingEngine(model, k=SERVE_K, max_batch=SERVE_MAX_BATCH,
                        dtype="bfloat16")
    ids16, scores16 = served(eng.serve(requests))
    users = np.concatenate(requests)
    _, s11 = model.recommend(users, k=SERVE_K + 1)
    tol = BF16_SCORE_TOL * np.maximum(1.0, np.abs(s11[:, SERVE_K - 1]))
    near = s11[:, SERVE_K - 1] - s11[:, SERVE_K] <= 2 * tol
    differ = np.array([set(a) != set(b) for a, b in zip(ids32, ids16)])
    close = np.abs(scores16 - scores32) <= BF16_SCORE_TOL * (
        1 + np.abs(scores32))
    if (differ & ~near).any() or not close.all():
        raise AssertionError(
            f"bf16 engine: {int((differ & ~near).sum())} users' id sets "
            f"differ away from a near-tie; scores beyond 2e-2: "
            f"{int((~close).sum())}")
    return {"bf16_sets_differ": int(differ.sum()),
            "bf16_sets_differ_at_near_ties": int((differ & near).sum()),
            "bf16_max_score_diff": float(np.abs(scores16 - scores32).max())}


def check_delta(model, users):
    """``apply_delta`` of ``DELTA_ROWS`` item rows on a flat two-stage
    engine against a fresh engine over the patched model: int8 codes,
    scales and the f32 rescore table bit-equal, served lists equal."""
    rng = np.random.default_rng(3)
    dmodel = dataclasses.replace(model)  # the fit model keeps its tables
    eng = ServingEngine(dmodel, k=SERVE_K, retrieval=RetrievalConfig(),
                        max_batch=SERVE_MAX_BATCH)
    v0 = eng.version
    rows = rng.choice(model.V.shape[0], DELTA_ROWS, replace=False)
    vals = rng.normal(0, 0.1, (DELTA_ROWS, model.rank)).astype(np.float32)
    v1, wall = timed(lambda: eng.apply_delta(item_rows=rows, V_rows=vals))
    fresh = ServingEngine(dmodel, k=SERVE_K, retrieval=RetrievalConfig(),
                          max_batch=SERVE_MAX_BATCH)
    a, b = eng.retriever, fresh.retriever
    same = (torch.equal(a.catalog.q, b.catalog.q)
            and torch.equal(a.catalog.scale, b.catalog.scale)
            and torch.equal(a.V, b.V) and not torch.equal(model.V, dmodel.V))
    ra, rb = eng.recommend(users), fresh.recommend(users)
    if not (same and v1 != v0 and np.array_equal(ra[0], rb[0])
            and np.array_equal(ra[1], rb[1])):
        raise AssertionError("apply_delta differs from a fresh engine over "
                             "the patched model")
    return {"delta_rows": DELTA_ROWS, "delta_wall_s": wall,
            "delta_codes_bit_equal": True, "delta_lists_equal": True}


def serve_armed(model, requests, ids, scores, ups):
    """The exact engine again with the transfer plane armed (the ``log``
    guard, so each flush's pipeline runs in ``serving.serve_rows``'s
    sync-debug scope): answers equal to the unarmed engine's, the implicit
    transfers counted at that site after a warm pass (the steady state),
    users/s against the unarmed engine's."""
    ledger = obs.enable_transfers(guard="log")
    try:
        eng = ServingEngine(model, k=SERVE_K, max_batch=SERVE_MAX_BATCH)
        eng.serve(requests)
        ledger.mark_steady()
        out, armed_ups, _ = best_serve(eng, requests)
        snap = ledger.snapshot()
    finally:
        obs.set_transfers(None)
    a_ids, a_scores = served(out)
    if not (np.array_equal(a_ids, ids) and np.array_equal(a_scores, scores)):
        raise AssertionError("serve.engine: the armed engine's answers "
                             "differ from the unarmed engine's")
    return {"armed_answers_equal": True,
            "armed_implicit_at_serve_rows":
                snap["implicit_by_site"].get("serving.serve_rows", 0),
            "armed_steady_implicit": snap["steady"]["implicit_transfers"],
            "armed_users_per_s": armed_ups,
            "armed_over_unarmed_users_per_s": armed_ups / ups}


def phase_serve_engine(model, cpu_model, train, serve_share):
    """``[serve.engine]`` on the trained ``fit`` model: the exact f32
    ``ServingEngine`` (max_batch 1,024, k 10) serves the 16,384 users of
    ``[serve]`` cut into seeded requests of 1–32 users (run_traffic's
    shape); its lists must equal ``model.recommend``'s (tie-aware) and the
    CPU engine's for 256 users; with ``train=`` no train item may be
    served; the bf16 engine holds the 2e-2 bound, the flat two-stage
    engine recall@10 ≥ 0.95, a delta swap equals a fresh engine. Then
    ``[serve.admission]`` on the flat engine."""
    users = model.users.sorted_ids[:SERVE_USERS]
    requests = cut_requests(users, np.random.default_rng(1))
    n, n_items, rank = len(users), model.V.shape[0], model.rank
    cuda_sgd.reset_launch_counts()
    exact = ServingEngine(model, k=SERVE_K, max_batch=SERVE_MAX_BATCH)
    out, ups, walls = best_serve(exact, requests)
    ids, scores = served(out)
    flops = 2 * n * n_items * rank
    bound_ms, bound_by = bound_of(
        n * rank * 4 + n_items * rank * 4 + n * SERVE_K * 8, flops)
    ref = model.recommend(users, k=SERVE_K)
    rec = check_topk("engine vs recommend", ids, scores, *ref)
    cpu_ids, cpu_scores = ServingEngine(cpu_model, k=SERVE_K).recommend(
        users[:256])
    cpu = check_topk("engine card vs CPU", ids[:256], scores[:256], cpu_ids,
                     cpu_scores)
    sub = users[:SERVE_WARM]
    ex = ServingEngine(model, k=SERVE_K, train=train,
                       max_batch=SERVE_MAX_BATCH)
    ex_ids, _ = served(ex.serve(cut_requests(sub, np.random.default_rng(2))))
    leaked, mine = train_items_served(train, sub, ex_ids)
    if leaked or (ex_ids < 0).any():
        raise AssertionError(f"engine(train=): {leaked} train items served")
    overlap = pipeline_overlap(ex, users)
    bf16 = check_bf16(model, requests, ids, scores)
    flat = ServingEngine(model, k=SERVE_K, retrieval=RetrievalConfig(),
                         max_batch=SERVE_MAX_BATCH)
    fl_out, fl_ups, fl_walls = best_serve(flat, requests)
    recall = recall_at_k(served(fl_out)[0], ids)
    if recall < RECALL_MIN:
        raise AssertionError(f"flat two-stage recall@10 {recall} < "
                             f"{RECALL_MIN}")
    delta = check_delta(model, users[:SERVE_WARM])
    armed = serve_armed(model, requests, ids, scores, ups)
    say("serve.engine", users=n, requests=len(requests), k=SERVE_K,
        item_rows=n_items, rank=rank, max_batch=SERVE_MAX_BATCH,
        users_per_s=ups, **ms_quantiles(walls),
        flushes_per_pass=len(walls) // 2,
        microbatches_per_pass=exact.stats["microbatches"] // 3,
        buckets_per_pass={b_: c // 3 for b_, c in
                          sorted(exact.stats["buckets"].items())},
        executable_variants=exact.executable_variants,
        bucket_family=list(exact.bucket_family), bound_ms=bound_ms,
        bound_by=bound_by, share_of_bound=bound_ms / 1e3 * ups / n,
        serve_share_of_bound=serve_share,
        recommend_max_score_diff=rec[0], recommend_ids_compared=rec[1],
        cpu_256_max_score_diff=cpu[0], cpu_256_ids_differ=cpu[2],
        excluded_users=len(sub), train_pairs_of_them=mine,
        train_items_served=leaked, **overlap, **bf16,
        flat_users_per_s=fl_ups, flat_recall_at_10=recall,
        **{f"flat_{k_}": v for k_, v in ms_quantiles(fl_walls).items()},
        flat_variants=flat.executable_variants,
        flat_catalog_bytes=flat.retriever.catalog.nbytes(), **delta,
        **armed, launches=no_dsgd_launches("serve.engine"))
    phase_serve_admission(flat, requests)


def phase_serve_admission(eng, requests):
    """``[serve.admission]``: an ``SLOTracker`` whose target no flush can
    meet drives the ladder. First with shedding out of reach: after the
    8-sample warmup it climbs to ``degrade`` and the flushes serve
    stage-1-only results flagged ``.degraded``. Then with the default
    thresholds: it sheds, and ``serve`` returns each shed request's
    ``AdmissionRejectedError`` in its place, every other request its own
    answer (against the same engine's exact or degraded lists)."""
    cuda_sgd.reset_launch_counts()
    head, tail = requests[:16], requests[16:400]
    eng.attach_admission(None)
    exact_ref = eng.serve(tail)
    slo = SLOTracker(target_s=1e-9, objective=0.9, window=32)
    climb = AdmissionController(slo, AdmissionConfig(shed_burn=1e9))
    eng.attach_admission(climb)
    levels = []
    for r in head:
        eng.recommend(r)
        levels.append(climb.level)
    degraded_ref = eng.serve(tail)
    if not (climb.level == "degrade" and all(r.degraded
                                             for r in degraded_ref)):
        raise AssertionError(f"admission: level {climb.level}, degraded "
                             f"flags {[r.degraded for r in degraded_ref]}")
    shed = AdmissionController(SLOTracker(target_s=1e-9, objective=0.9,
                                          window=32), AdmissionConfig())
    eng.attach_admission(shed)
    out = eng.serve(tail)
    rejected = [i for i, r in enumerate(out)
                if isinstance(r, AdmissionRejectedError)]
    kept = [i for i, r in enumerate(out)
            if not isinstance(r, AdmissionRejectedError)]
    for i in kept:
        want = degraded_ref[i] if out[i].degraded else exact_ref[i]
        if out[i][0].shape != (len(tail[i]), SERVE_K):
            raise AssertionError(f"admission: request {i} misaligned")
        check_topk(f"admission request {i}", out[i][0], out[i][1], want[0],
                   want[1])
    if not (rejected and kept and shed.level == "shed"
            and all(r.level == "shed" for r in
                    (out[i] for i in rejected))):
        raise AssertionError(f"admission: {len(rejected)} shed, "
                             f"{len(kept)} served, level {shed.level}")
    eng.attach_admission(None)
    say("serve.admission", target_s=1e-9, objective=0.9, window=32,
        climb_levels=levels, climb_final=climb.level,
        degraded_requests=climb.degraded, shed_requests=len(rejected),
        served_requests=len(kept),
        served_degraded=sum(out[i].degraded for i in kept),
        shed_final=shed.level, shed_transitions=shed.transitions,
        in_order=True, launches=no_dsgd_launches("serve.admission"))


# [obs.serve]: the request-plane SLO (a flush of 1,024 rows takes ~4.6 ms
# on the card, so requests queued behind one miss it and the rest meet it)
OBS_SERVE_SLO_S = 0.005
OBS_SERVE_DELTA_ROWS = 4096
OBS_SERVE_ROUTES = ("/lineagez", "/criticalpathz", "/contentionz",
                    "/budgetz", "/slowz", "/metrics")


def same_answers(a, b) -> bool:
    """Two ``serve`` result lists hold equal ids and scores, request by
    request (exact: the same ops on the same tables)."""
    return len(a) == len(b) and all(
        np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
        for x, y in zip(a, b))


def phase_obs_serve(model, smi):
    """``[obs.serve]``: the exact f32 engine of ``[serve.engine]`` (the
    ``fit`` tables, max_batch 1,024, k 10, the 16,384 users in requests of
    1–32) with the request, rollout, lineage and critical-path planes on
    and an ``ObsServer`` scraped from a second thread: it serves the stream,
    takes an ``apply_delta`` swap of 4,096 item rows into a second version
    (the canary cohort), and serves it again. Checks: answers equal to a
    planes-off engine's through the same swap; every flush's stages fsum
    to its wall; ``/slowz`` keeps every SLO-violating request; ``/budgetz``
    two cohorts and a verdict; ``/lineagez`` both swaps; every scrape 200.
    Reports the stage fractions, the planes' cost on users/s (min of 5
    passes, interleaved with the planes-off engine) and one ``note_flush``'s
    host µs. Returns the launch counts (none: serving runs torch ops)."""
    phase_t0 = time.perf_counter()
    users = model.users.sorted_ids[:SERVE_USERS]
    requests = cut_requests(users, np.random.default_rng(1))
    rows = np.random.default_rng(7).choice(model.V.shape[0],
                                           OBS_SERVE_DELTA_ROWS,
                                           replace=False)
    vals = model.V[torch.as_tensor(rows, device=model.V.device)] * 1.01
    cuda_sgd.reset_launch_counts()

    def engine():  # each engine's deltas patch its own model binding
        return ServingEngine(dataclasses.replace(model), k=SERVE_K,
                             max_batch=SERVE_MAX_BATCH)

    off = engine()
    off.serve(requests)  # warm
    ref1 = off.serve(requests)
    off.apply_delta(item_rows=rows, V_rows=vals)
    ref2 = off.serve(requests)

    reg, _ = obs.enable()
    lineage = obs.enable_lineage()
    obs.enable_disttrace()
    budget = obs.enable_budget(OBS_SERVE_SLO_S, objective=0.99,
                               min_samples=64)
    tel = obs.enable_requests(OBS_SERVE_SLO_S, objective=0.99, window=4096,
                              max_exemplars=8192)
    flushes = []  # (stages, flush wall, note_flush host seconds)
    real_note = tel.note_flush

    def note(ledger, end, stamps, **kw):
        t0 = time.perf_counter()
        real_note(ledger, end, stamps, **kw)
        flushes.append((dict(ledger.stages), end - ledger.t0,
                        time.perf_counter() - t0))

    tel.note_flush = note
    server = obs.ObsServer().start()
    scraper = Scraper(server.url, OBS_SERVE_ROUTES)
    scraper.start()
    try:
        while scraper.rounds() < 1:
            time.sleep(0.01)
        on = engine()
        v1 = on.version
        got1 = on.serve(requests)
        v2 = on.apply_delta(item_rows=rows, V_rows=vals)
        got2 = on.serve(requests)
        verdict = budget.verdicts.evaluate(v2, v1)
        start_round = scraper.rounds()
        while scraper.rounds() < start_round + 1:  # a round after it all
            time.sleep(0.01)
    finally:
        scraper.halt.set()
        scraper.join(timeout=30)
        server.stop()
    tel.note_flush = real_note
    snap = tel.snapshot(limit=0)
    codes = collections.Counter((e[0], e[3]) for e in scraper.log)
    budgetz = json.loads(scraper.bodies["/budgetz"])
    lineagez = json.loads(scraper.bodies["/lineagez"])
    slowz = json.loads(scraper.bodies["/slowz"])
    swaps = {r["catalog_version"]: r["source"] for r in lineagez["records"]}
    kept_viol = sum(e["violating"] for e in tel.exemplars())
    unreconciled = sum(math.fsum(st.values()) != wall
                       for st, wall, _ in flushes)
    note_us = sorted(t * 1e6 for _, _, t in flushes)

    # the planes' cost: passes of the same stream, interleaved off / on
    walls_on, walls_off = [], []
    for _ in range(5):
        walls_off.append(timed(lambda: off.serve(requests))[1])
        walls_on.append(timed(lambda: on.serve(requests))[1])
    n_users = sum(len(r) for r in requests)
    ups_on, ups_off = n_users / min(walls_on), n_users / min(walls_off)
    launches = no_dsgd_launches("obs.serve")
    obs.disable()
    say("obs.serve", card=smi, users=n_users, requests=len(requests),
        slo_target_s=OBS_SERVE_SLO_S, versions=[v1, v2],
        answers_equal_planes_off=[same_answers(got1, ref1),
                                  same_answers(got2, ref2)],
        flushes=len(flushes), flushes_unreconciled=unreconciled,
        stage_frac=snap["stage_frac"], dominant_stage=snap["dominant_stage"],
        request_p50_ms=snap["p50_ms"], request_p99_ms=snap["p99_ms"],
        requests_noted=snap["count"], violations=snap["violations"],
        violating_kept=kept_viol, kept=snap["kept"],
        slowz_count=slowz.get("count"),
        budget_cohorts={v: c["served"]
                        for v, c in budgetz["cohorts"].items()},
        verdict=verdict["verdict"], verdict_reason=verdict["reason"],
        budgetz_verdicts=budgetz["verdicts"]["evaluations"],
        lineage_swaps=swaps,
        scrape_codes={f"{rt} {c}": n for (rt, c), n in codes.items()},
        scrape_rounds=scraper.rounds(),
        users_per_s_planes_on=ups_on, users_per_s_planes_off=ups_off,
        on_over_off_users_per_s=ups_on / ups_off,
        pass_walls_s_on=walls_on, pass_walls_s_off=walls_off,
        note_flush_us_min=note_us[0],
        note_flush_us_p50=note_us[len(note_us) // 2],
        note_flush_us_max=note_us[-1], launches=launches,
        phase_wall_s=time.perf_counter() - phase_t0)
    if not (same_answers(got1, ref1) and same_answers(got2, ref2)):
        raise AssertionError("obs.serve: answers differ from the planes-off "
                             "engine's")
    if not flushes or unreconciled:
        raise AssertionError(f"obs.serve: {unreconciled} of {len(flushes)} "
                             "flushes' stages do not fsum to their wall")
    if not (snap["violations"] > 0 and kept_viol == snap["violations"]
            and snap["count"] == 2 * len(requests)):
        raise AssertionError(f"obs.serve: {kept_viol} of "
                             f"{snap['violations']} violating requests kept "
                             f"({snap['count']} noted)")
    if (set(budgetz["cohorts"]) != {str(v1), str(v2)}
            or not budgetz["verdicts"]["evaluations"]):
        raise AssertionError(f"obs.serve: /budgetz cohorts "
                             f"{sorted(budgetz['cohorts'])}, verdicts "
                             f"{budgetz['verdicts']['evaluations']}")
    if swaps.get(v1) != "engine_refresh" or swaps.get(v2) != "engine_delta":
        raise AssertionError(f"obs.serve: /lineagez swaps {swaps}")
    if any(c != 200 for (_, c) in codes) or scraper.rounds() < 2:
        raise AssertionError(f"obs.serve: scrapes {dict(codes)}")
    if lineage.resolve(v2)["verdict"] != verdict["verdict"]:
        raise AssertionError("obs.serve: the verdict is not in lineage")
    return launches


def build_structured_model(dev, num_users, num_items, rank, n_centers=256,
                           spread=2.0, noise=0.3, seed=0):
    """scripts/serving_bench.py:251's catalog on the card: items drawn
    around ``n_centers`` Gaussian centers, isotropic Gaussian users, the
    same numpy draws."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_centers, rank)) * spread
    V = (centers[rng.integers(0, n_centers, num_items)]
         + noise * rng.normal(size=(num_items, rank))).astype(np.float32)
    U = rng.normal(size=(num_users, rank)).astype(np.float32)
    return MFModel(U=torch.from_numpy(U).to(dev),
                   V=torch.from_numpy(V).to(dev),
                   users=flat_index(np.arange(num_users, dtype=np.int64)),
                   items=flat_index(np.arange(num_items, dtype=np.int64)))


def two_stage_parts(ret, U_chunk, reps=5):
    """One bucket of the clustered fast path split with CUDA events into
    routing, the probe loop, the overflow block, the top-kc and stage 2,
    each beside its bound (each input byte read once, each output written
    once; probed slabs and gathered rows counted once per distinct one)."""
    cat, dev = ret.catalog, U_chunk.device
    b, r = U_chunk.shape
    C, m, _ = cat.slab_q.shape
    p, O = min(ret.config.n_probe, C), cat.ovf_q.shape[0]
    kc = ret.candidate_count(SERVE_K)
    excl = tuple(torch.from_numpy(a).to(dev) for a in
                 topk.exclusion_builder(None, None, 1)(np.zeros(b), b))
    names = ("route", "probes", "overflow", "topkc", "stage2")
    ms = dict.fromkeys(names, 0.0)
    for rep in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        cid = ret_ops._route(U_chunk, cat.centroids, p)
        ev[1].record()
        scores = torch.empty((b, p * m + O), device=dev)
        rows = torch.empty((b, p * m + O), dtype=torch.int64, device=dev)
        for pi in range(p):
            c = cid[:, pi]
            scores[:, pi * m:(pi + 1) * m] = ret_ops._score_probe(
                U_chunk, c, cat.slab_q, cat.slab_scale, cat.slab_w)
            rows[:, pi * m:(pi + 1) * m] = cat.slab_rows[c]
        ev[2].record()
        scores[:, p * m:] = ret_ops._score_overflow(
            U_chunk, cat.ovf_q, cat.ovf_scale, cat.ovf_w)
        rows[:, p * m:] = cat.ovf_rows[None, :]
        ev[3].record()
        v, pos = topk.lax_top_k(scores, kc)
        cand = rows.gather(1, pos)
        ev[4].record()
        out = ret_ops._stage2(U_chunk, ret.V, cat.item_w, v, cand, *excl,
                              k=SERVE_K, exact=True)
        ev[5].record()
        ev[5].synchronize()
        if rep:  # the first pass warms
            for i, name in enumerate(names):
                ms[name] += ev[i].elapsed_time(ev[i + 1]) / reps
    whole = ret.topk(U_chunk, excl, k=SERVE_K)
    if not (torch.equal(whole[0], out[0]) and torch.equal(whole[1], out[1])):
        raise AssertionError("two-stage parts differ from TwoStageRetriever"
                             ".topk")
    dc = int(torch.unique(cid).numel())
    dr = int(torch.unique(cand).numel())
    del out
    bounds = {
        "route": bound_of(b * r * 4 + C * r * 4 + b * p * 8, 2 * b * C * r),
        "probes": bound_of(dc * m * (r + 16) + b * r * 4 + b * p * m * 12,
                           2 * b * p * m * r),
        "overflow": bound_of(O * (r + 16) + b * r * 4 + b * O * 12,
                             2 * b * O * r),
        "topkc": bound_of(b * (p * m + O) * 12 + b * kc * 12, 0),
        "stage2": bound_of(dr * (r * 4 + 4) + b * kc * 12 + b * r * 4
                           + b * SERVE_K * 12, 2 * b * kc * r)}
    res = {"bucket": b, "probed_clusters": dc, "candidates": kc,
           "distinct_candidate_rows": dr}
    for name in names:
        res[f"{name}_ms"] = ms[name]
        res[f"{name}_bound_ms"], res[f"{name}_bound_by"] = bounds[name]
    return res


def phase_serve_two_stage(dev):
    """``[serve.two_stage]`` at SERVING_r03.json's geometry: 20,000 users ×
    1,048,576 items at rank 64 around 256 centers (seed 0); the clustered
    index (512 clusters, 16 probes, overfetch 4, a 65,536-row k-means
    sample) and the exact engine serve 400 seeded requests of 1–32 users
    (max_batch 1,024), best of 2 after warming the bucket family; recall@10
    of 256 users ≥ 0.95; one 256-row bucket split into its parts."""
    cuda_sgd.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    model, gen_s = timed(lambda: build_structured_model(dev, **TWO_STAGE))
    nu, rank = TWO_STAGE["num_users"], TWO_STAGE["rank"]
    rng = np.random.default_rng(TWO_STAGE["seed"] + 1)
    requests = [rng.integers(0, nu, int(sz)).astype(np.int64) for sz in
                rng.integers(1, SERVE_REQ_MAX + 1, TWO_STAGE_REQUESTS)]
    cfg = RetrievalConfig(**TWO_STAGE_CFG)
    fast, build_s = timed(lambda: ServingEngine(
        model, k=SERVE_K, retrieval=cfg, max_batch=SERVE_MAX_BATCH))
    exact = ServingEngine(model, k=SERVE_K, max_batch=SERVE_MAX_BATCH)
    empty = tuple(torch.from_numpy(a).to(dev) for a in
                  topk.exclusion_builder(None, None, 1)(np.zeros(8), 8))
    bucket = 8
    while bucket <= min(SERVE_MAX_BATCH, cfg.max_bucket):
        for stage1_only in (False, True):
            fast.retriever.topk(torch.zeros((bucket, rank), device=dev),
                                empty, k=SERVE_K, stage1_only=stage1_only)
        exact.recommend(np.zeros(bucket, np.int64))
        bucket <<= 1
    rates, walls = {}, {}
    for name, eng in (("fast", fast), ("exact", exact)):
        _, rates[name], walls[name] = best_serve(eng, requests)
    sample = rng.integers(0, nu, RECALL_USERS).astype(np.int64)
    recall = recall_at_k(fast.recommend(sample)[0],
                         exact.recommend(sample)[0])
    if recall < RECALL_MIN:
        raise AssertionError(f"clustered two-stage recall@10 {recall} < "
                             f"{RECALL_MIN}")
    parts = two_stage_parts(fast.retriever, model.U[torch.from_numpy(
        sample).to(dev)])
    n_items = TWO_STAGE["num_items"]
    say("serve.two_stage", users=nu, items=n_items, rank=rank,
        requests=len(requests),
        request_rows=sum(len(r) for r in requests), k=SERVE_K,
        generation_wall_s=gen_s, build_wall_s=build_s,
        index=fast.retriever.catalog.stats,
        fast_users_per_s=rates["fast"], exact_users_per_s=rates["exact"],
        fast_vs_exact=rates["fast"] / rates["exact"],
        fast_variants=fast.executable_variants,
        **{f"fast_{k}": v for k, v in ms_quantiles(walls["fast"]).items()},
        **{f"exact_{k}": v for k, v in ms_quantiles(walls["exact"]).items()},
        recall_at_10=recall, recall_users=RECALL_USERS,
        f32_catalog_gb=n_items * rank * 4 / 1e9,
        int8_catalog_gb=fast.retriever.catalog.nbytes() / 1e9,
        exact_chunk_gb=SERVE_MAX_BATCH * n_items * 4 / 1e9,
        peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9, **parts,
        launches=no_dsgd_launches("serve.two_stage"))


STAGE1 = dict(b=256, n=2_262_292, rank=64, kc=2000, per_row=66)
INT8_OP_PER_S = 1979e12  # H100 SXM dense int8 (NVIDIA's data sheet)


def stage1_route(args, kc):
    """Flat stage 1 as the port ran it before its kernels: the ``[b, N]``
    f32 score matrix (``int8_scores``, the scales' outer product, the
    weights, the scatter-min) and ``lax_top_k``; the yardstick
    ``library_ms`` times."""
    qU, u_scale, Q, scale, item_w, er, ec, ew = args
    scores = ret_ops.int8_scores(qU, Q)
    scores *= u_scale[:, None] * scale[None, :]
    scores += item_w[None, :]
    topk.apply_exclusions(scores, er, ec, ew)
    return scores, topk.lax_top_k(scores, kc)


def same_selection(label, got, want, scores):
    """Values bit-equal, each row's items returned with their own scores,
    items equal wherever their score is above the kc-th value."""
    (v, r), (wv, wr) = got, want
    if not torch.equal(v.view(torch.int32), wv.view(torch.int32)):
        raise AssertionError(f"{label}: values differ from the route's")
    if not torch.equal(scores.gather(1, r).view(torch.int32),
                       v.view(torch.int32)):
        raise AssertionError(f"{label}: an item carries another's score")
    above = v > v[:, -1:]
    if not torch.equal(r[above], wr[above]):
        raise AssertionError(f"{label}: items above the kc-th value differ")
    if not bool((r.sort(dim=1).values.diff(dim=1) > 0).all()):
        raise AssertionError(f"{label}: an item appears twice in a row")


def phase_kernels_stage1(dev):
    """``[kernels.stage1]``: the kernels at the two-stage cell's bucket
    against the score-matrix route and the plain version, each timed."""
    b, n, rank, kc = (STAGE1[k] for k in ("b", "n", "rank", "kc"))
    g = torch.Generator(device=dev).manual_seed(23)
    Q, scale = ret_ops.quantize_rows(torch.randn((n, rank), generator=g,
                                                 device=dev))
    qU, u_scale = ret_ops.quantize_rows(torch.randn((b, rank), generator=g,
                                                    device=dev))
    item_w = torch.zeros(n, device=dev)
    e = STAGE1["per_row"] * b
    args = (qU, u_scale, Q, scale, item_w,
            torch.randint(0, b, (e,), generator=g, device=dev).int(),
            torch.randint(0, n, (e,), generator=g, device=dev).int(),
            torch.full((e,), topk.DEAD_SLOT_OFFSET, device=dev))
    got = stage1_select.stage1_select(*args, kc=kc)  # builds and warms
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    stage1_select.reset_launch_counts()
    got = stage1_select.stage1_select(*args, kc=kc)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    launches = dict(stage1_select.LAUNCHES)  # the checked call's alone
    if launches != {"stage1_select_launch": 1}:
        raise AssertionError(f"stage1: the checked call launched {launches}")
    scores, want = stage1_route(args, kc)
    same_selection("stage1 kernels vs route", got, want, scores)
    del scores
    plain = stage1_select.stage1_select_reference(*args, kc=kc)
    route = stage1_route(args, kc)
    same_selection("stage1 plain vs route", plain, route[1], route[0])
    same_selection("stage1 kernels vs plain", got, plain, route[0])
    del route, plain
    ms = cuda_ms(lambda: stage1_select.stage1_select(*args, kc=kc), 10)
    library_ms = cuda_ms(lambda: stage1_route(args, kc), 3)
    plain_ms = cuda_ms(lambda: stage1_select.stage1_select_reference(
        *args, kc=kc), 2, warmup=1)
    ops_s = 2.0 * b * n * rank / INT8_OP_PER_S
    bytes_s = n * (rank + 8) / HBM_BYTES_PER_S
    say("kernels.stage1", route="cuda",
        source="large_scale_recommendation_tpu_torch/csrc/stage1_select.cu",
        replaces="none (the JAX package leaves stage 1 to XLA)", bucket=b,
        items=n, rank=rank, kc=kc, exclusions=e, ms=ms,
        bound_ms=1e3 * max(ops_s, bytes_s),
        bound_by="operations" if ops_s >= bytes_s else "bytes",
        roofline_pct=100.0 * 1e3 * max(ops_s, bytes_s) / ms,
        plain_ms=plain_ms, library_ms=library_ms,
        peak_above_inputs_gb=peak / 1e9, matrix_gb=b * n * 4 / 1e9,
        launches=launches)


# -- ALS and online MF (no kernel of their own: torch ops on the card) ------

ALS_RANKS = ((64, 2), (128, 2), (256, 1))  # bench.py:758-762
ALS_LAMBDA = 0.01
IMPLICIT_PAIRS, IMPLICIT_NEGATIVES, COVERAGE_USERS = 20_000, 100, 2048
CONV_NNZ, CONV_RANK, CONV_ROUNDS, CONV_TARGET = 25_000_095, 32, 7, 0.155
ONLINE_BATCHES, ONLINE_BATCH, ONLINE_UPDATES = 10, 100_000, 20_000
ONLINE_CPU_BATCHES, ONLINE_CKPT_AFTER = 3, 5


def timed(fn):
    """(fn(), host seconds) with the card's queue drained on both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def no_dsgd_launches(label):
    """The ALS and online paths run torch ops only: none of the four
    kernels may have launched since the counts were reset."""
    launches = dict(cuda_sgd.LAUNCHES)
    if any(launches.values()):
        raise AssertionError(f"{label}: DSGD kernels launched: {launches}")
    return launches


def als_rounds_timed(V, prep_u, prep_v, nu, ni, n, implicit=False):
    """``n`` rounds of ``als_rounds`` in one call, with CUDA events per
    round; returns (U, V, host wall of all n, device ms per round)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ms = []
    U, V = als_ops.als_rounds(V, prep_u, prep_v, nu, ni, ALS_LAMBDA, n,
                              implicit=implicit, round_ms=ms)
    torch.cuda.synchronize()
    return U, V, time.perf_counter() - t0, ms


def plan_by_row(prepared, num_rows):
    """Chunked buckets as {pad: [rows, oidx, vals, w, scale]} in row order,
    chunk-padding rows dropped (rows are unique within a plan)."""
    out = {}
    for rows3, oidx3, vals3, w3, sc3 in prepared:
        rows = rows3.reshape(-1)
        keep = rows != num_rows
        order = torch.sort(rows[keep]).indices
        out[oidx3.shape[-1]] = [rows[keep][order]] + [
            a.reshape(rows.shape[0], -1)[keep][order]
            for a in (oidx3, vals3, w3, sc3)]
    return out


def same_plan(host, device, num_rows) -> bool:
    hb, db = plan_by_row(host, num_rows), plan_by_row(device, num_rows)
    return sorted(hb) == sorted(db) and all(
        torch.equal(a, b) for pad in hb for a, b in zip(hb[pad], db[pad]))


def plan_shape(prepared):
    """(padded entries, rows incl. chunk padding, chunks, pads)."""
    return (sum(b[1].numel() for b in prepared),
            sum(b[0].numel() for b in prepared),
            sum(b[0].shape[0] for b in prepared),
            [b[1].shape[-1] for b in prepared])


def half_step_bound(prepared, k, num_rows):
    """The least time of one half-step on this card: the gram and solve
    operations of these buckets (2·padded·k² + 2·padded·k for the grams and
    right-hand sides, k³/3 + 2·k² a row for Cholesky and the two triangular
    solves) in f32, and the bytes it must move (the gathered rows, the
    plan's 12 B per padded entry, the solved table written)."""
    padded, rows, _, _ = plan_shape(prepared)
    flops = 2 * padded * k * k + 2 * padded * k + rows * (k ** 3 / 3
                                                         + 2 * k * k)
    nbytes = padded * (k * 4 + 12) + num_rows * k * 4
    return bound_of(nbytes, flops), flops, nbytes


def half_step_parts(V, prepared, num_rows):
    """One half-step's device ms in three runs over the same chunks:
    gather + grams only, + ``cholesky_ex``, and the whole half-step
    (``solve_side``: + triangular solves + write-back); the parts by
    subtraction."""
    lam = ALS_LAMBDA

    def grams():
        with topk.ieee_f32():
            for rows3, oidx3, vals3, w3, sc3 in prepared:
                for c in range(rows3.shape[0]):
                    als_ops._gram_chunk(V, oidx3[c], vals3[c], w3[c])

    def cholesky():
        eye = torch.eye(V.shape[-1], device=V.device)
        with topk.ieee_f32():
            for rows3, oidx3, vals3, w3, sc3 in prepared:
                for c in range(rows3.shape[0]):
                    A, _ = als_ops._gram_chunk(V, oidx3[c], vals3[c], w3[c])
                    torch.linalg.cholesky_ex(A + lam * eye)

    whole = cuda_ms(lambda: als_ops.solve_side(V, prepared, num_rows, lam),
                    reps=3, warmup=1)
    g = cuda_ms(grams, reps=3, warmup=1)
    c = cuda_ms(cholesky, reps=3, warmup=1)
    return {"half_step_ms": whole, "gather_gram_ms": g,
            "cholesky_ms": c - g, "solves_writeback_ms": whole - c,
            "cholesky_share": (c - g) / whole}


def check_solved_rows(U, V, au, ai, ar, lam, n_rows=4096):
    """``n_rows`` seeded rows of a solved side against a float64 dense
    normal-equation solve (tests/test_als.py:382's bar)."""
    order = np.argsort(au, kind="stable")
    su, si, sr = au[order], ai[order], ar[order]
    starts = np.searchsorted(su, np.arange(U.shape[0] + 1))
    active = np.nonzero(np.diff(starts))[0]
    rows = np.random.default_rng(0).choice(active, n_rows, replace=False)
    got = U[torch.as_tensor(rows, device=U.device)].double().cpu().numpy()
    Vh = V.double().cpu().numpy()
    k = Vh.shape[1]
    worst = 0.0
    for j, r in enumerate(rows):
        sl = slice(starts[r], starts[r + 1])
        Vr = Vh[si[sl]]
        x = np.linalg.solve(Vr.T @ Vr + lam * np.eye(k), Vr.T @ sr[sl])
        worst = max(worst, float((np.abs(got[j] - x)
                                  / (3e-3 * np.abs(x) + 3e-4)).max()))
    if not worst <= 1.0:
        raise AssertionError(f"solved rows vs float64: {worst:.3f} of the "
                             "3e-3·|x| + 3e-4 bar")
    return n_rows, worst


def phase_als(dev):
    """Paths 1, 2 and 4: the bench's ALS lines (bench.py:736-849) on
    2,000,000 planted ratings at ML-25M width, and ``ALS.fit``."""
    (train, hold, (nu, ni)), gen_s = timed(
        lambda: device_blocking.synthetic_like_device(
            "ml-25m", nnz=int(2_000_000 / 0.95) + 1, rank=16, noise=0.1,
            seed=1, skew_lam=2.0, device=dev))
    au, ai, ar = train
    cuda_sgd.reset_launch_counts()
    (prep_u, prep_v), plan_s = timed(lambda: (
        als_ops.device_prepare_side(au, ai, ar, nu, rank_for_chunking=256),
        als_ops.device_prepare_side(ai, au, ar, ni, rank_for_chunking=256)))
    h = [a.cpu().numpy() for a in (au, ai, ar)]
    t0 = time.perf_counter()
    host_u = als_ops.prepare_side(als_ops.build_solve_plan(h[0], h[1], h[2],
                                                           nu), None, 256,
                                  device=dev)
    host_v = als_ops.prepare_side(als_ops.build_solve_plan(h[1], h[0], h[2],
                                                           ni), None, 256,
                                  device=dev)
    host_plan_s = time.perf_counter() - t0
    if not (same_plan(host_u, prep_u, nu) and same_plan(host_v, prep_v, ni)):
        raise AssertionError("device plan differs from the host plan")
    del host_u, host_v
    shape_u, shape_v = plan_shape(prep_u), plan_shape(prep_v)
    say("als.data", train=au.shape[0], holdout=hold[0].shape[0], users=nu,
        items=ni, generation_wall_s=gen_s, device_plan_wall_s=plan_s,
        host_plan_wall_s=host_plan_s, plans_equal_row_for_row=True,
        padded_entries_u=shape_u[0], padded_entries_v=shape_v[0],
        chunks_u=shape_u[2], chunks_v=shape_v[2], pads_u=shape_u[3],
        pads_v=shape_v[3], linalg=str(
            torch.backends.cuda.preferred_linalg_library()))
    holdout = dense_holdout(*hold)
    init = {}
    for rank, iters in ALS_RANKS:
        init[rank] = PseudoRandomFactorInitializer(rank, scale=0.1)(
            torch.arange(ni, device=dev))
        als_rounds_timed(init[rank], prep_u, prep_v, nu, ni, 1)  # warm-up
        U, V, wall, round_ms = als_rounds_timed(init[rank], prep_u, prep_v,
                                                nu, ni, iters)
        line = dict(rank=rank, rounds=iters, wall_s=wall, round_ms=round_ms,
                    rows_per_s=(nu + ni) * iters / wall,
                    rmse=holdout.of(U, V))
        if rank == 128:
            U1 = als_ops.solve_side(init[rank], prep_u, nu, ALS_LAMBDA)
            line["solved_rows_checked"], line["solved_rows_worst_of_bar"] = \
                check_solved_rows(U1, init[rank], *h, ALS_LAMBDA)
            (bu, fl, nb) = half_step_bound(prep_u, rank, nu)
            line.update(half_step_parts(init[rank], prep_u, nu),
                        half_step_bound_ms=bu[0], half_step_bound_by=bu[1],
                        half_step_gflop=fl / 1e9, half_step_mbytes=nb / 1e6)
            del U1
        if not math.isfinite(line["rmse"]):
            raise AssertionError(f"als rank {rank}: RMSE {line['rmse']}")
        say("als", **line)
        if rank == 128:
            phase_als_implicit(init[rank], prep_u, prep_v, nu, ni, h, hold)
        del U, V
    # the entry point: ALS.fit_device (its own plans, rank 64) against the
    # bench route's rank-64 rounds from the same keyed init
    cfg = ALSConfig(num_factors=64, lambda_=ALS_LAMBDA, iterations=2,
                    init_scale=0.1)
    solver = ALS(cfg)
    als_ops.reset_launch_counts()
    model, wall = timed(lambda: solver.fit_device(au, ai, ar, nu, ni))
    fused = dict(als_ops.LAUNCHES)
    U, V, _, _ = als_rounds_timed(init[64], prep_u, prep_v, nu, ni, 2)
    rmse, rmse_route = holdout.of(model.U, model.V), holdout.of(U, V)
    say("als.fit_device", rank=64, rounds=2, wall_s=wall,
        plan_build_s=solver.plan_s, round_ms=solver.round_ms, rmse=rmse,
        rmse_bench_route=rmse_route, launches=no_dsgd_launches("als"),
        fused_launches=fused)
    if fused != {"als_solve_launch": 2 * 2}:
        raise AssertionError(f"fit_device took the fused route {fused} "
                             "times, expected once a half-step")
    if not abs(rmse - rmse_route) <= 1e-4:
        raise AssertionError(f"fit_device RMSE {rmse} vs the bench route "
                             f"{rmse_route}")
    # implicit: the weighted build once a half-step, against the bench
    # route's implicit rounds from the same init (items without ratings 0,
    # as fit_device starts them: the whole-table gram sees every row)
    solver = ALS(dataclasses.replace(cfg, implicit_alpha=1.0))
    als_ops.reset_launch_counts()
    obs_trace.reset_span_totals()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        model, wall = timed(lambda: solver.fit_device(au, ai, ar, nu, ni))
    fused = dict(als_ops.LAUNCHES)
    solve = obs_trace.span_totals()["als/solve"]
    seen = torch.bincount(ai.long(), minlength=ni) > 0
    iu, iv = (als_ops.implicit_prepared(p, 1.0) for p in (prep_u, prep_v))
    U, V, _, _ = als_rounds_timed(init[64] * seen[:, None], iu, iv, nu, ni,
                                  2, implicit=True)
    gap = max((a - b).abs().max().item() / b.abs().max().item()
              for a, b in ((model.U, U), (model.V, V)))
    say("als.fit_device.implicit", rank=64, alpha=1.0, rounds=2,
        wall_s=wall, round_ms=solver.round_ms, fused_launches=fused,
        solve_spans=solve["count"], solve_rows=solve["args"]["rows"],
        weighted_rows=solve["args"]["weighted"],
        max_rel_vs_bench_route=gap)
    if fused != {"als_solve_launch": 2 * 2} or solve["count"] != 2 * 2:
        raise AssertionError(f"implicit fit_device launched {fused} in "
                             f"{solve['count']} spans, expected once a "
                             "half-step")
    if solve["args"]["weighted"] != solve["args"]["rows"]:
        raise AssertionError(f"implicit fit_device: {solve['args']}, "
                             "expected the weighted build on every row")
    if not gap <= 1e-3:  # sums in another order over four half-steps
        raise AssertionError(f"implicit fit_device {gap:.3e} from the "
                             "bench route")
    del prep_u, prep_v, iu, iv, model, U, V, init
    phase_als_fit(h, hold, nu, ni)


def dense_holdout(hu, hi, hv):
    """Holdout RMSE of dense-id tables on the card, every pair counted (as
    bench.py's ``conv_rmse``)."""
    return DeviceHoldoutEval(hu, hi, hv, torch.ones(hu.shape[0],
                                                    device=hu.device))


def phase_als_implicit(V0, prep_u, prep_v, nu, ni, h, hold):
    """Path 2: iALS (α 1, rank 128, 2 rounds) on the same buckets through
    ``implicit_prepared``, its sampled HR/NDCG (bench.py:793-837) and
    catalog coverage, each also on the CPU from the same tables."""
    iu, iv = (als_ops.implicit_prepared(p, 1.0) for p in (prep_u, prep_v))
    als_rounds_timed(V0, iu, iv, nu, ni, 1, implicit=True)  # warm-up
    U, V, wall, round_ms = als_rounds_timed(V0, iu, iv, nu, ni, 2,
                                            implicit=True)
    hu = hold[0][:IMPLICIT_PAIRS].cpu().numpy()
    hi = hold[1][:IMPLICIT_PAIRS].cpu().numpy()
    kw = dict(k=10, num_negatives=IMPLICIT_NEGATIVES, train_u=h[0],
              train_i=h[1], seed=7)
    q, q_s = timed(lambda: metrics.sampled_ranking_metrics(U, V, hu, hi,
                                                           **kw))
    Uc, Vc = U.cpu(), V.cpu()
    qc = metrics.sampled_ranking_metrics(Uc, Vc, hu, hi, **kw)
    users = np.unique(hu)
    if len(users) > COVERAGE_USERS:
        users = np.random.default_rng(7).choice(users, COVERAGE_USERS,
                                                replace=False)
    cov_kw = dict(k=10, train_u=h[0], train_i=h[1])
    cov, cov_s = timed(lambda: metrics.catalog_coverage(U, V, users,
                                                        **cov_kw))
    cov_cpu = metrics.catalog_coverage(Uc, Vc, users, **cov_kw)
    say("als.implicit", rank=128, alpha=1.0, rounds=2, wall_s=wall,
        round_ms=round_ms, rows_per_s=(nu + ni) * 2 / wall, hr10=q["hr"],
        ndcg10=q["ndcg"], hr10_floor=10 / (IMPLICIT_NEGATIVES + 1),
        valid_negatives=q["valid_negatives"], hr10_cpu=qc["hr"],
        ndcg10_cpu=qc["ndcg"], metrics_wall_s=q_s, coverage=cov,
        coverage_cpu=cov_cpu, coverage_users=len(users),
        coverage_wall_s=cov_s)
    if not (abs(q["hr"] - qc["hr"]) <= 1e-5
            and abs(q["ndcg"] - qc["ndcg"]) <= 1e-5
            and q["valid_negatives"] == qc["valid_negatives"]):
        raise AssertionError(f"implicit metrics card {q} vs CPU {qc}")
    if cov != cov_cpu:
        raise AssertionError(f"coverage card {cov} vs CPU {cov_cpu}")


def phase_als_fit(h, hold, nu, ni):
    """Path 4: ``ALS.fit`` (host id maps and plans) on the same 2,000,000
    ratings at rank 128, 2 rounds, in f32 and with bf16 grams."""
    train = Ratings.from_arrays(*h)
    holdout = Ratings.from_arrays(*(a.cpu().numpy() for a in hold))
    rmse = {}
    for gram in (None, "bf16"):
        cfg = ALSConfig(num_factors=128, lambda_=ALS_LAMBDA, iterations=2,
                        init_scale=0.1, gram_dtype=gram)
        solver = ALS(cfg)
        cuda_sgd.reset_launch_counts()
        model, wall = timed(lambda: solver.fit(train))
        rmse[gram] = model.rmse(holdout)
        say("als.fit", gram_dtype=gram or "f32", rank=128, rounds=2,
            wall_s=wall, plan_build_s=solver.plan_s,
            round_ms=solver.round_ms, rmse=rmse[gram],
            users=model.users.num_rows, items=model.items.num_rows,
            launches=no_dsgd_launches("als.fit"))
        if not math.isfinite(rmse[gram]):
            raise AssertionError(f"ALS.fit RMSE {rmse[gram]}")
    gap = abs(rmse["bf16"] - rmse[None])
    say("als.fit.bf16", rmse_f32=rmse[None], rmse_bf16=rmse["bf16"], gap=gap)
    if not gap < 0.01:
        raise AssertionError(f"bf16 gram RMSE gap {gap} ≥ 0.01")


def phase_als_conv(dev):
    """Path 3: rank-32 time to RMSE 0.155 (bench.py:851-907): 25,000,095
    generated ratings, plans built on the card, up to 7 rounds with the
    holdout RMSE after each."""
    (train, hold, (nu, ni)), gen_s = timed(
        lambda: device_blocking.synthetic_like_device(
            "ml-25m", nnz=CONV_NNZ, rank=16, noise=0.1, seed=4,
            skew_lam=2.0, device=dev))
    cu, ci, cr = train
    cuda_sgd.reset_launch_counts()
    (pu, pv), plan_s = timed(lambda: (
        als_ops.device_prepare_side(cu, ci, cr, nu,
                                    rank_for_chunking=CONV_RANK),
        als_ops.device_prepare_side(ci, cu, cr, ni,
                                    rank_for_chunking=CONV_RANK)))
    V = PseudoRandomFactorInitializer(CONV_RANK, scale=0.1)(
        torch.arange(ni, device=dev))
    holdout = dense_holdout(*hold)
    als_rounds_timed(V, pu, pv, nu, ni, 1)  # warm-up, not timed
    curve, walls, dev_ms, time_to = [], [], [], None
    for _ in range(CONV_ROUNDS):
        U, V, wall, ms = als_rounds_timed(V, pu, pv, nu, ni, 1)
        curve.append(holdout.of(U, V))
        walls.append(wall)
        dev_ms += ms
        if curve[-1] <= CONV_TARGET:
            time_to = sum(walls)
            break
    say("als.conv", train=cu.shape[0], rank=CONV_RANK, generation_wall_s=gen_s,
        plan_wall_s=plan_s, padded_entries=plan_shape(pu)[0]
        + plan_shape(pv)[0], rmse_per_round=curve, round_wall_s=walls,
        round_ms=dev_ms, target=CONV_TARGET, time_to_target_s=time_to,
        launches=no_dsgd_launches("als.conv"))
    # falls: ends below where it started, at its lowest; round 2 may tick
    # up, as the JAX package's own run of this path does
    # (docs/BENCH_TPU_r5_manual.json: 0.3112, 0.3172, 0.2684, 0.1645)
    if not (all(math.isfinite(x) for x in curve)
            and curve[-1] < curve[0] and curve[-1] == min(curve)):
        raise AssertionError(f"ALS holdout RMSE did not fall: {curve}")


ALS_KERNEL = dict(nnz=25_000_095, rank=128, lam=0.1)  # ml25m_r128.als_fit
ALS_KERNEL_TOL = 2e-4  # of the largest |x|: sums in another order
IALS_KERNEL = dict(config="portbench/configs/mpd_ials_r64.json",
                   seed=3_000_002_651)  # mpd_ials_r64.ials_fit


def fused_half_step_counts(plan, k, n_other):
    """(FLOPs, bytes) of one fused half-step: per rating the gram's lower
    triangle and b (k(k + 1)/2 + k FMAs), per row a Cholesky and two
    triangular solves (k³/6 + k² FMAs); the fixed side read once, 8 B of
    plan a rating and 16 B a row, the solved table written once."""
    e, n = plan.cols.numel(), plan.rows.numel()
    fmas = e * (k * (k + 1) / 2 + k) + n * (k ** 3 / 6 + k * k)
    nbytes = 4 * k * (n_other + plan.num_rows) + 8 * e + 16 * n
    return 2 * fmas, nbytes


def kernels_als_side(side, F, plan, buckets, lam, G, counts, **facts):
    """One side of ``[kernels.als]``: two launches (bit-equal, the only
    ones since the reset), the kernel against its plain version and the
    bucketed route, each timed, beside the bound of ``counts(plan)``
    ((FLOPs, bytes)). Returns the kernel's table."""
    k = F.shape[1]
    als_ops.reset_launch_counts()
    got = als_ops.als_solve(F, plan, lam, G)
    again = als_ops.als_solve(F, plan, lam, G)
    torch.cuda.synchronize()
    launches = dict(als_ops.LAUNCHES)
    bit_equal = torch.equal(got.view(torch.int32), again.view(torch.int32))
    del again
    scale = got.abs().max().item()
    plain = als_ops.als_solve_reference(F, plan, lam, G)
    vs_plain = (got - plain).abs().max().item() / scale
    del plain
    bucketed = als_ops.solve_side(F, buckets, plan.num_rows, lam, G)
    vs_bucketed = (got - bucketed).abs().max().item() / scale
    del bucketed
    ms = cuda_ms(lambda: als_ops.als_solve(F, plan, lam, G), 5)
    plain_ms = cuda_ms(
        lambda: als_ops.als_solve_reference(F, plan, lam, G), 2, warmup=1)
    library_ms = cuda_ms(
        lambda: als_ops.solve_side(F, buckets, plan.num_rows, lam, G), 2,
        warmup=1)
    flops, nbytes = counts(plan)
    bound_ms, bound_by = bound_of(nbytes, flops)
    say("kernels.als", side=side, route="cuda",
        source="large_scale_recommendation_tpu_torch/csrc/als_solve.cu",
        replaces="none (the JAX package solves ALS with XLA ops)",
        rows=plan.rows.numel(), ratings=plan.cols.numel(), rank=k,
        weighted=plan.w is not None, ms=ms, bound_ms=bound_ms,
        bound_by=bound_by, roofline_pct=100.0 * bound_ms / ms,
        gflop=flops / 1e9, mbytes=nbytes / 1e6, plain_ms=plain_ms,
        library_ms=library_ms, max_rel_vs_plain=vs_plain,
        max_rel_vs_bucketed=vs_bucketed, two_launches_bit_equal=bit_equal,
        launches=launches, **facts)
    if launches != {"als_solve_launch": 2}:
        raise AssertionError(f"kernels.als {side}: launched {launches}")
    if not (bit_equal and torch.isfinite(got).all()):
        raise AssertionError(f"kernels.als {side}: two launches differ or "
                             "NaN")
    if not max(vs_plain, vs_bucketed) <= ALS_KERNEL_TOL:
        raise AssertionError(f"kernels.als {side}: {vs_plain:.3e} from the "
                             f"plain version, {vs_bucketed:.3e} from the "
                             "bucketed route")
    return got


def phase_kernels_als(dev):
    """``[kernels.als]``: the fused half-step at ML-25M shapes, both
    sides, against its plain version and the bucketed route, each timed;
    then its weighted build at the iALS cell's."""
    k, lam = ALS_KERNEL["rank"], ALS_KERNEL["lam"]
    (train, _, (nu, ni)), gen_s = timed(
        lambda: device_blocking.synthetic_like_device(
            "ml-25m", nnz=ALS_KERNEL["nnz"], rank=16, noise=0.1, seed=5,
            skew_lam=2.0, device=dev))
    u, i, r = train
    (pu, pv), plan_s = timed(lambda: (
        als_ops.device_csr_plan(u, i, r, nu),
        als_ops.device_csr_plan(i, u, r, ni)))
    (bu, bv), bucket_s = timed(lambda: (
        als_ops.device_prepare_side(u, i, r, nu, rank_for_chunking=k),
        als_ops.device_prepare_side(i, u, r, ni, rank_for_chunking=k)))
    F = PseudoRandomFactorInitializer(k, scale=0.1)(
        torch.arange(ni, device=dev))
    ptxas = [line.strip() for line in _build.build_log.get(
        "als_solve", "").splitlines() if "registers" in line
        or "spill" in line]
    for side, plan, buckets in (("users", pu, bu), ("items", pv, bv)):
        # the item side solves from the users just solved
        F = kernels_als_side(
            side, F, plan, buckets, lam, None,
            lambda p, n_other=F.shape[0]: fused_half_step_counts(p, k,
                                                                 n_other),
            generation_wall_s=gen_s, csr_plans_wall_s=plan_s,
            bucket_plans_wall_s=bucket_s, ptxas=ptxas)
    del pu, pv, bu, bv, train, u, i, r, F
    phase_kernels_ials(dev)


def phase_kernels_ials(dev):
    """``[kernels.als]`` at ``mpd_ials_r64.ials_fit``'s shapes: the
    configuration's pairs drawn and coalesced as the cell's set-up does,
    both sides' implicit plans (``implicit_csr``), the weighted build with
    each side's YᵀY as G against its plain version and the bucketed
    implicit route (``implicit_prepared``), beside
    ``reference/ials_counts.py``'s bound."""
    with open(IALS_KERNEL["config"]) as f:
        cfg = json.load(f)
    data, block = cfg["data"], cfg["als"]
    nu, ni = int(data["num_users"]), int(data["num_items"])
    k, lam = block["num_factors"], block["lambda_"]
    alpha = block["implicit_alpha"]
    (u, i, r), gen_s = timed(lambda: coalesce(
        *bench_data.dataset(data, IALS_KERNEL["seed"], dev)[:2], ni))
    (pu, pv), plan_s = timed(lambda: tuple(
        als_ops.implicit_csr(als_ops.device_csr_plan(a, b, r, n), alpha)
        for a, b, n in ((u, i, nu), (i, u, ni))))
    (bu, bv), bucket_s = timed(lambda: tuple(
        als_ops.implicit_prepared(als_ops.device_prepare_side(
            a, b, r, n, rank_for_chunking=k), alpha)
        for a, b, n in ((u, i, nu), (i, u, ni))))
    del u, i, r
    F = PseudoRandomFactorInitializer(k, scale=0.1)(
        torch.arange(ni, device=dev))
    for side, plan, buckets in (("users", pu, bu), ("items", pv, bv)):
        F = kernels_als_side(
            f"ials.{side}", F, plan, buckets, lam, als_ops._full_gram(F),
            lambda p: (ials_counts.half_step_flops(
                p.rows.numel(), p.cols.numel(), k),
                ials_counts.half_step_bytes(
                    p.rows.numel(), p.cols.numel(), k)),
            alpha=alpha, longest_row=int(plan.cnt[0]),
            generation_wall_s=gen_s, csr_plans_wall_s=plan_s,
            bucket_plans_wall_s=bucket_s)
    del pu, pv, bu, bv, F


def online_parts(om, batch):
    """One more batch through ``partial_fit``'s steps, each synchronized:
    registering its ids (``acquire_rows``, both tables), staging (padding
    and the host→device copies), and ``online_train`` (host wall beside
    its CUDA-event time). The trained tables are not installed."""
    cfg = om.config
    ru, ri, rv, _ = batch.to_numpy()
    (u_rows, i_rows), ensure_s = timed(lambda: (om.users.acquire_rows(ru),
                                                om.items.acquire_rows(ri)))
    staged, stage_s = timed(lambda: [
        torch.from_numpy(a).to(om.device) for a in sgd_ops.pad_minibatches(
            u_rows, i_rows, rv, cfg.minibatch_size)])
    a, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    _, train_s = timed(lambda: sgd_ops.online_train(
        om.users.array, om.items.array, *staged, updater=om.updater,
        minibatch=cfg.minibatch_size, iterations=cfg.iterations_per_batch,
        collision=cfg.collision_mode))
    e.record()
    e.synchronize()
    say("online.parts", ratings=batch.n, padded=staged[0].shape[0],
        ensure_s=ensure_s, stage_s=stage_s, online_train_s=train_s,
        online_train_device_ms=a.elapsed_time(e))


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms for the bit-equality legs: the
    card's ``index_add_`` adds a minibatch's duplicate rows with atomics in
    a varying order, so two runs of the same online stream differ in the
    last places whatever obs does; the deterministic ``index_add_`` fixes
    the order. Ops without a deterministic version only warn, and fresh
    memory is left unfilled, as outside the mode."""
    import torch.utils.deterministic as det

    fill = det.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        det.fill_uninitialized_memory = fill


ONLINE_OBS_PAIRS = 5


def online_run(cfg, batches, planes=None):
    """A fresh ``OnlineMF`` over ``batches`` (ingest mode), each batch
    synchronized. ``planes`` (``None``: obs off) is the transfer guard's
    mode: the registry, an event journal and a transfer ledger with that
    guard are installed before the model is built (the hooks bind at
    construction) and left installed for the caller to read. Returns
    (model, per-batch walls, the planes' handles)."""
    handles = {}
    if planes is not None:
        handles["reg"], _ = obs.enable()
        handles["journal"] = obs.EventJournal()
        obs.set_events(handles["journal"])
        handles["ledger"] = obs.enable_transfers(guard=planes)
    om = OnlineMF(cfg)
    walls = []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        om.partial_fit(b, emit_updates=False)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return om, walls, handles


def same_online(a, b) -> bool:
    """Two online models hold the same ids in the same rows and bit-equal
    tables."""
    return all(x.capacity == y.capacity
               and np.array_equal(x.id_array(), y.id_array())
               and torch.equal(x.array, y.array)
               for x, y in ((a.users, b.users), (a.items, b.items)))


def phase_online_obs(cfg, batches, up, smi):
    """``[online.obs]``: the [online] stream with the online model's obs
    hooks on (registry, journal, a transfer ledger) against off, ratings/s
    as the min of 5 runs a side in turns (batches after the first):
    ``on`` with the ledger's guard off (the production setting),
    ``guarded`` with its ``log`` guard (each batch's ``online_train`` in a
    sync-debug scope). From the last guarded run: ``online_batch_s``'s p50
    beside the synchronized batch wall, the counters against the batches
    and ratings applied, the implicit transfers at ``online.partial_fit``,
    the staging notes' bytes, the growth events against the capacity
    doublings. Then, under ``deterministic()``, one run each way: tables
    bit-equal; and one updates-emitting batch's ``online.emit_updates``
    note."""
    ratings = sum(b.n for b in batches[1:])
    walls = {"off": [], "on": [], "guarded": []}
    sides = (("off", None), ("on", "off"), ("guarded", "log"))
    for rep in range(ONLINE_OBS_PAIRS):  # in turns: ABC, CBA, ABC, ...
        for side, planes in (sides if rep % 2 == 0 else sides[::-1]):
            om, w, h = online_run(cfg, batches, planes)
            walls[side].append(sum(w[1:]))
            if side == "guarded":
                hist = h["reg"].histogram("online_batch_s")
                n_batches = h["reg"].counter("online_batches_total").value
                n_ratings = h["reg"].counter("online_ratings_total").value
                snap = h["ledger"].snapshot()
                growth = len(h["journal"].events("online.table_growth"))
                batch_wall_p50 = float(np.percentile(w, 50))
            obs.disable()
            del om
    stage = snap["sites"].get("online.minibatch_stage", {})
    staged = sum(4 * 4 * cfg.minibatch_size * next_pow2(
        -(-b.n // cfg.minibatch_size)) for b in batches)
    implicit = snap["implicit_by_site"].get("online.partial_fit", 0)
    with deterministic():
        off, _, _ = online_run(cfg, batches)
        on, _, h = online_run(cfg, batches, "log")
        equal = same_online(on, off)
        ups = on.partial_fit(up)
        emit = h["ledger"].snapshot()["sites"].get("online.emit_updates", {})
        obs.disable()
    rows = len(ups.user_arrays[0]) + len(ups.item_arrays[0])
    best = {side: min(w) for side, w in walls.items()}
    say("online.obs", card=smi, runs_each=ONLINE_OBS_PAIRS,
        batches=len(batches),
        **{f"ratings_per_s_{side}": ratings / t for side, t in best.items()},
        on_over_off_ratings_per_s=best["off"] / best["on"],
        guarded_over_off_ratings_per_s=best["off"] / best["guarded"],
        **{f"walls_{side}_s": w for side, w in walls.items()},
        online_batch_s_p50_ms=hist.quantile(0.5) * 1e3,
        online_batch_s_count=hist.count, batch_wall_p50_ms=batch_wall_p50
        * 1e3, online_batches_total=n_batches,
        online_ratings_total=n_ratings, implicit_at_partial_fit=implicit,
        implicit_by_site=snap["implicit_by_site"],
        stage_h2d_bytes=stage.get("h2d_bytes"), stage_h2d_want=staged,
        stage_count=stage.get("h2d_count"), growth_events=growth,
        emit_d2h_bytes=emit.get("d2h_bytes"),
        emit_d2h_want=rows * cfg.num_factors * 4,
        emit_wait_s=emit.get("wait_s"), tables_bit_equal_on_off=equal)
    if not equal:
        raise AssertionError("online.obs: tables with the hooks on differ "
                             "from off under deterministic algorithms")
    if (hist.count != len(batches) or n_batches != len(batches)
            or n_ratings != sum(b.n for b in batches)):
        raise AssertionError(f"online.obs: histogram {hist.count}, counters "
                             f"{n_batches} / {n_ratings}")
    if (stage.get("h2d_bytes") != staged
            or stage.get("h2d_count") != len(batches)
            or emit.get("d2h_bytes") != rows * cfg.num_factors * 4
            or emit.get("d2h_count") != 1):
        raise AssertionError(f"online.obs: transfer notes {stage} / {emit}")
    if growth != 0:  # 2^19 rows a table: the stream never grows one
        raise AssertionError(f"online.obs: {growth} growth events")


def phase_online(dev, scratch, smi):
    """Path 5: the Netflix-shaped online stream (bench.py:919-975) through
    ``OnlineMF.partial_fit``: 10 batches of 100,000 (the first a warm-up),
    each synchronized; the first 3 also on the CPU from the same keyed
    init; a snapshot after batch 5 restored into a fresh model; then one
    updates-emitting segment of 20,000."""
    gen = SyntheticMFGenerator(num_users=480_189, num_items=17_770, rank=16,
                               noise=0.1, seed=2, skew_lam=2.0)
    batches = [gen.generate(ONLINE_BATCH) for _ in range(ONLINE_BATCHES)]
    cfg = OnlineMFConfig(num_factors=128, learning_rate=0.05,
                         minibatch_size=16384, init_capacity=1 << 19)
    cuda_sgd.reset_launch_counts()
    om = OnlineMF(cfg)
    cpu = OnlineMF(cfg, device="cpu")
    worst = 0.0
    lat = []
    manager = CheckpointManager(os.path.join(scratch, "online"))
    for n, b in enumerate(batches):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        om.partial_fit(b, emit_updates=False)
        torch.cuda.synchronize()
        if n:  # the first batch is the warm-up
            lat.append(time.perf_counter() - t1)
        if n < ONLINE_CPU_BATCHES:
            cpu.partial_fit(b, emit_updates=False)
            for a, c in ((om.users, cpu.users), (om.items, cpu.items)):
                if not (a.capacity == c.capacity
                        and np.array_equal(a.id_array(), c.id_array())):
                    raise AssertionError("online ids → rows differ between "
                                         "the card and the CPU")
                got, want = a.array[:a.num_rows].cpu(), c.array[:c.num_rows]
                if not torch.allclose(got, want, rtol=1e-4, atol=1e-5):
                    raise AssertionError("online tables: card vs CPU beyond "
                                         "rtol 1e-4 / atol 1e-5")
                worst = max(worst, float((got - want).abs().max()))
        if n == ONLINE_CKPT_AFTER:
            save_s = timed(lambda: save_online_state(manager, om, n))[1]
    del cpu
    restored = OnlineMF(cfg)
    restore_s = timed(lambda: restore_online_state(manager, restored))[1]
    saved = manager.restore()
    equal = all(
        np.array_equal(t.id_array(), saved[ids])
        and torch.equal(t.array[:t.num_rows].cpu(), torch.from_numpy(saved[a]))
        for t, ids, a in ((restored.users, "user_ids", "U"),
                          (restored.items, "item_ids", "V")))
    if not (equal and restored.step == ONLINE_CKPT_AFTER + 1):
        raise AssertionError("restored online tables differ from the saved")
    b = batches[1]
    nu_b, ni_b = len(np.unique(b.users)), len(np.unique(b.items))
    row = cfg.num_factors * 4
    bound = bound_of(2 * (nu_b + ni_b) * row + b.n * 16,
                     b.n * 6 * cfg.num_factors)
    half = lat[len(lat) // 2:]
    say("online", batches=len(lat), batch=ONLINE_BATCH, rank=cfg.num_factors,
        ratings_per_s=ONLINE_BATCH * len(lat) / sum(lat),
        batch_ms_p50=float(np.percentile(lat, 50)) * 1e3,
        batch_ms_p99=float(np.percentile(lat, 99)) * 1e3,
        batch_ms_max=max(lat) * 1e3,
        ratings_per_s_steady=ONLINE_BATCH * len(half) / sum(half),
        batch_ms=[x * 1e3 for x in lat], users=om.users.num_rows,
        items=om.items.num_rows, capacity_u=om.users.capacity,
        capacity_i=om.items.capacity, batch_distinct_u=nu_b,
        batch_distinct_i=ni_b, batch_bound_ms=bound[0],
        batch_bound_by=bound[1], card_vs_cpu_batches=ONLINE_CPU_BATCHES,
        card_vs_cpu_max_abs=worst, ckpt_after_batch=ONLINE_CKPT_AFTER,
        save_s=save_s, restore_s=restore_s, restored_bit_equal=True)
    online_parts(om, gen.generate(ONLINE_BATCH))
    up = [gen.generate(ONLINE_UPDATES) for _ in range(2)]
    om.partial_fit(up[0])  # warm the updates-emitting path
    ups, wall = timed(lambda: om.partial_fit(up[1]))
    rows = len(ups.user_arrays[0]) + len(ups.item_arrays[0])
    if rows != len(np.unique(up[1].users)) + len(np.unique(up[1].items)):
        raise AssertionError(f"updates-only output has {rows} rows")
    say("online.updates", ratings=ONLINE_UPDATES, wall_s=wall,
        ratings_per_s=ONLINE_UPDATES / wall, rows_emitted=rows,
        launches=no_dsgd_launches("online"))
    del om
    phase_online_obs(cfg, batches, up[1], smi)
    no_dsgd_launches("online.obs")


# -- streams: the log, the driver, the parallel runner and the adaptive
# model (host code and torch ops; the adaptive DSGD retrain runs the step
# pair) ---------------------------------------------------------------------

NETFLIX = dict(num_users=480_189, num_items=17_770, rank=16, noise=0.1,
               skew_lam=2.0)  # bench.py:919-975, as [online]
STREAM_BATCH, STREAM_CKPT_EVERY = 100_000, 4
LOG_BATCHES, LOG_PARTS, LOG_FSYNC_BATCHES = 32, 4, 8
DRIVER_BATCHES, DRIVER_CRASH_AFTER = 16, 9
PAR_BATCHES, PAR_STRATA, PAR_CONSUMERS = 32, 4, (1, 2, 4)
PAR_CRASH_AFTER = 14
ADAPT_BATCHES, ADAPT_HOLDOUT = 12, 50_000
RETRAIN_RMSE_TOL = 1e-4  # holdout RMSE, a retrain's kernel fit vs plain
ONLINE_TOL = dict(rtol=1e-4, atol=1e-5)  # [online]'s card bar


class _Crash(RuntimeError):
    """The simulated consumer crash of the kill/resume legs."""


def stream_online_cfg() -> OnlineMFConfig:
    return OnlineMFConfig(num_factors=128, learning_rate=0.05,
                          minibatch_size=16384, init_capacity=1 << 19)


def netflix_batches(seed, n, holdout=0):
    gen = SyntheticMFGenerator(seed=seed, **NETFLIX)
    out = [gen.generate(STREAM_BATCH) for _ in range(n)]
    return (out, gen.generate(holdout)) if holdout else out


def same_tables(a, b, label, tol=ONLINE_TOL) -> float:
    """Two online models hold the same ids with factors within ``tol``
    (rows matched by id: registration order may differ between runs);
    returns the largest difference."""
    worst = 0.0
    for side in ("users", "items"):
        ta, tb = getattr(a, side), getattr(b, side)
        ids = np.sort(ta.id_array())
        if not np.array_equal(ids, np.sort(tb.id_array())):
            raise AssertionError(f"{label}: {side} id sets differ")
        x = ta.array[torch.as_tensor(ta.rows_for(ids)[0], device=ta.device)]
        y = tb.array[torch.as_tensor(tb.rows_for(ids)[0], device=tb.device)]
        if not torch.allclose(x, y, **tol):
            raise AssertionError(f"{label}: {side} tables beyond {tol}")
        worst = max(worst, float((x - y).abs().max()))
    return worst


def coverage(applied, total, label) -> int:
    """Every record of ``[0, total)`` was applied at least once; returns
    how many were applied more than once."""
    covered = np.zeros(total, np.int32)
    for lo, hi in applied:
        covered[lo:hi] += 1
    if not (covered >= 1).all():
        raise AssertionError(f"{label}: lost {int((covered == 0).sum())} "
                             "records")
    return int((covered > 1).sum())


def same_serving(engine, model, label, users=4096):
    """An engine's tables equal ``model.to_model()``'s row for row, and its
    lists equal a fresh engine's for ``users`` users."""
    ref = model.to_model()
    if not (torch.equal(engine.model.U, ref.U)
            and torch.equal(engine.model.V, ref.V)):
        raise AssertionError(f"{label}: engine tables differ from the live "
                             "model's")
    ids = model.users.id_array()[:users]
    a, b = engine.recommend(ids), ServingEngine(ref, k=engine.k).recommend(ids)
    if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])):
        raise AssertionError(f"{label}: lists differ from a fresh engine's")


def phase_streams_log(scratch):
    """The WAL at the stream's shape: 32 × 100,000 records over 4
    partitions (append and read rates; the re-read by a new instance equal
    to what was appended), a torn tail cut off by the next append, and one
    8-batch ``fsync=True`` leg."""
    batches = netflix_batches(3, LOG_BATCHES)
    path = os.path.join(scratch, "wal")
    journal = obs.EventJournal()
    obs.set_events(journal)  # the log reads it at construction
    log = EventLog(path, num_partitions=LOG_PARTS, fsync=False)
    obs.set_events(None)
    t0 = time.perf_counter()
    for k, b in enumerate(batches):
        log.append(k % LOG_PARTS, b)
    append_s = time.perf_counter() - t0
    # one wal.segment_roll per roll: each partition's segments after its
    # first, their bases in order
    segs = {part.directory: [seg[0] for seg in part.segments]
            for part in log._parts}
    rolls = [(e["detail"]["directory"], e["detail"]["sealed_base"],
              e["detail"]["new_base"])
             for e in journal.events("wal.segment_roll")]
    want = sorted((d, a, b_) for d, bases in segs.items()
                  for a, b_ in zip(bases, bases[1:]))
    if sorted(rolls) != want:
        raise AssertionError(f"streams.log: {len(rolls)} roll events against "
                             f"{len(want)} rolls")
    log.close()
    n = LOG_BATCHES * STREAM_BATCH
    reader = EventLog(path, num_partitions=LOG_PARTS, fsync=False)
    got = {p: [] for p in range(LOG_PARTS)}
    t0 = time.perf_counter()
    for p in range(LOG_PARTS):
        off = 0
        while True:
            r, nxt = reader.read(p, off, STREAM_BATCH)
            if nxt == off:
                break
            got[p].append(r)
            off = nxt
    read_s = time.perf_counter() - t0
    for p in range(LOG_PARTS):
        for f in ("users", "items", "ratings"):
            if not np.array_equal(
                    np.concatenate([getattr(r, f) for r in got[p]]),
                    np.concatenate([getattr(w, f) for w in
                                    batches[p::LOG_PARTS]])):
                raise AssertionError(f"log re-read of p{p} differs ({f})")
    # a crashed append's 7 stray bytes on partition 0
    part = reader._parts[0]
    seg = part._seg_path(part.segments[-1][0])
    end = reader.end_offset(0)
    reader.close()
    with open(seg, "ab") as f:
        f.write(b"\x01" * 7)
    torn = EventLog(path, num_partitions=LOG_PARTS, fsync=False)
    if torn.end_offset(0) != end:
        raise AssertionError("a torn tail changed the end offset")
    if torn.append(0, batches[0]) != (end, end + STREAM_BATCH):
        raise AssertionError("the append after a torn tail got wrong offsets")
    base = torn._parts[0].segments[-1][0]
    if os.path.getsize(torn._parts[0]._seg_path(base)) != \
            HEADER_SIZE + (end + STREAM_BATCH - base) * RECORD_SIZE:
        raise AssertionError("the torn tail was not cut off")
    back, _ = torn.read(0, end, STREAM_BATCH)
    if not np.array_equal(back.users, batches[0].users):
        raise AssertionError("the append after a torn tail reads back wrong")
    torn.close()
    synced = EventLog(os.path.join(scratch, "wal_fsync"), fsync=True)
    t0 = time.perf_counter()
    for b in batches[:LOG_FSYNC_BATCHES]:
        synced.append(0, b)
    fsync_s = time.perf_counter() - t0
    synced.close()
    n_sync = LOG_FSYNC_BATCHES * STREAM_BATCH
    say("streams.log", records=n, partitions=LOG_PARTS, batch=STREAM_BATCH,
        bytes=n * RECORD_SIZE, append_s=append_s,
        append_records_per_s=n / append_s,
        append_bytes_per_s=n * RECORD_SIZE / append_s, read_s=read_s,
        read_records_per_s=n / read_s,
        read_bytes_per_s=n * RECORD_SIZE / read_s, reread_equal=True,
        torn_tail_cut=True, fsync_records=n_sync, fsync_s=fsync_s,
        fsync_records_per_s=n_sync / fsync_s, segment_rolls=len(want),
        roll_events=len(rolls), launches=no_dsgd_launches("streams.log"))


def phase_streams_driver(scratch):
    """One partition of 16 batches drained by ``StreamingDriver(OnlineMF)``
    against the bare ``partial_fit`` loop over the same batches, in turns
    (bare, durable, durable, bare), tables within the online bar; a crash
    after batch 9 resumed with zero loss; a ``serving_engine()`` refreshed
    by a delta that equals a full refresh row for row."""
    batches = netflix_batches(4, DRIVER_BATCHES)
    log = EventLog(os.path.join(scratch, "drv_log"), fsync=False)
    for b in batches:
        log.append(0, b)
    total = DRIVER_BATCHES * STREAM_BATCH
    cfg = stream_online_cfg()
    dcfg = StreamingDriverConfig(batch_records=STREAM_BATCH,
                                 checkpoint_every=STREAM_CKPT_EVERY)

    def bare():
        om = OnlineMF(cfg)
        return om, timed(lambda: [om.partial_fit(b, emit_updates=False)
                                  for b in batches])[1]

    def durable(k):
        om = OnlineMF(cfg)
        ck = os.path.join(scratch, f"drv_ck{k}")
        drv = StreamingDriver(om, log, ck, config=dcfg)
        drv.manager = TimedCheckpoints(ck)
        applied, wall = timed(drv.run)
        if (applied, drv.consumed_offset) != (DRIVER_BATCHES, total):
            raise AssertionError(f"the driver applied {applied} batches to "
                                 f"offset {drv.consumed_offset}")
        return om, drv, wall

    bare_model, bare1_s = bare()
    dur_model, drv, dur1_s = durable(1)
    dur2_s = durable(2)[2]
    bare2_s = bare()[1]
    worst = same_tables(dur_model, bare_model, "driver vs bare loop")
    del bare_model, dur_model
    tele = drv.telemetry()
    saves = drv.manager.saves
    if drv.checkpoints_written != DRIVER_BATCHES // STREAM_CKPT_EVERY:
        raise AssertionError(f"{drv.checkpoints_written} checkpoints")
    bare_rate = 2 * total / (bare1_s + bare2_s)
    dur_rate = 2 * total / (dur1_s + dur2_s)
    say("streams.driver", batches=DRIVER_BATCHES, batch=STREAM_BATCH,
        bare_wall_s=[bare1_s, bare2_s], durable_wall_s=[dur1_s, dur2_s],
        bare_ratings_per_s=bare_rate, durable_ratings_per_s=dur_rate,
        retention=dur_rate / bare_rate,
        queue_high_water=tele["queue"]["depth_high_water"],
        queue_capacity=dcfg.queue_capacity,
        blocked_puts=tele["queue"]["blocked_puts"],
        checkpoints=drv.checkpoints_written,
        checkpoint_wall_s=[w for w, _ in saves],
        checkpoint_bytes=saves[-1][1], driver_vs_bare_max_abs=worst)
    del drv

    # crash after batch 9 (the checkpoint after batch 8 landed), resume
    applied = []
    ck = os.path.join(scratch, "drv_crash")

    def crash(b):
        applied.append((b.start_offset, b.end_offset))
        if len(applied) == DRIVER_CRASH_AFTER:
            raise _Crash()

    d1 = StreamingDriver(OnlineMF(cfg), log, ck, config=dcfg, on_batch=crash)
    try:
        d1.run()
        raise AssertionError("the crash leg did not crash")
    except _Crash:
        pass
    del d1
    # the resumed driver publishes into a live registry, its telemetry
    # exported on a 0.25 s cadence and scraped from /metrics
    reg, _ = obs.enable()
    server = obs.ObsServer(registry=reg).start()
    m2 = OnlineMF(cfg)
    d2 = StreamingDriver(m2, log, ck, config=dcfg, on_batch=lambda b:
                         applied.append((b.start_offset, b.end_offset)))
    exporter = d2.start_telemetry_export(0.25)
    if not d2.resume():
        raise AssertionError("no checkpoint to resume from")
    restored = d2.consumed_offset
    resume_s = timed(d2.run)[1]
    replayed = coverage(applied, total, "driver crash") // STREAM_BATCH
    if d2.consumed_offset != log.end_offset(0) or \
            replayed > STREAM_CKPT_EVERY:
        raise AssertionError(f"resume ended at {d2.consumed_offset} of "
                             f"{log.end_offset(0)}, {replayed} replayed")

    # serving: one engine, one more batch over known ids, a delta refresh
    engine = d2.serving_engine(k=SERVE_K)
    v0 = engine.version
    log.append(0, batches[0])
    exported = [lag_scrape(server, reg, STREAM_BATCH)]  # the exporter's
    exported.append(d2.telemetry()["lag_records"])
    d2.run()
    exported += [lag_scrape(server, reg, 0), d2.telemetry()["lag_records"]]
    d2.stop_telemetry_export()
    server.stop()
    obs.disable()
    if exported != [STREAM_BATCH, STREAM_BATCH, 0, 0] or exporter.running \
            or exporter.errors:
        raise AssertionError(f"exported lag / telemetry {exported}, "
                             f"exporter running {exporter.running}, "
                             f"errors {exporter.errors}")
    delta_s = timed(lambda: d2.refresh_serving(delta=True))[1]
    if engine.version == v0 or d2.catalog_versions[-1] != engine.version:
        raise AssertionError("the delta refresh moved no catalog version")
    same_serving(engine, m2, "delta refresh")
    full_s = timed(lambda: engine.refresh(m2.to_model()))[1]
    if d2.consumed_offset != log.end_offset(0):
        raise AssertionError("the driver stopped short of the log end")
    say("streams.driver.crash", crash_after_batch=DRIVER_CRASH_AFTER,
        restored_offset=restored, replayed_batches=replayed,
        bound=STREAM_CKPT_EVERY, lost=0, resume_drain_s=resume_s,
        consumed_offset=d2.consumed_offset, log_end=log.end_offset(0),
        delta_rows=len(np.unique(batches[0].users))
        + len(np.unique(batches[0].items)), delta_refresh_s=delta_s,
        full_refresh_s=full_s, delta_equals_full=True,
        exported_lag_then_telemetry=exported, exporter_runs=exporter.runs,
        launches=no_dsgd_launches("streams.driver"))


def lag_scrape(server, reg, want, timeout_s=10.0):
    """The ``streams_lag_records{partition="0"}`` a ``/metrics`` scrape
    shows once the telemetry exporter (not a hand call) has published
    ``want``."""
    gauge = reg.gauge("streams_lag_records", partition="0")
    deadline = time.perf_counter() + timeout_s
    while gauge.value != want and time.perf_counter() < deadline:
        time.sleep(0.05)
    code, text = http_get(server.url + "/metrics", timeout=5.0)
    if code != 200:
        raise AssertionError(f"/metrics answered {code}")
    lag = [v for name, labels, v in obs.parse_prometheus(text)
           if name == "streams_lag_records" and labels == {"partition": "0"}]
    if len(lag) != 1:
        raise AssertionError(f"/metrics lag samples {lag}")
    return int(lag[0])


def strata(seed):
    """``PAR_STRATA`` row-disjoint streams of ``PAR_BATCHES / PAR_STRATA``
    batches over the Netflix universe, drawn as scripts/streams_bench.py's
    ``_stratum_batch`` draws them: stratum s holds users ≡ s (mod 4) and
    the items of block s."""
    rng = np.random.default_rng(seed)
    u_blk = NETFLIX["num_users"] // PAR_STRATA
    i_blk = NETFLIX["num_items"] // PAR_STRATA
    return [[(rng.integers(0, u_blk, STREAM_BATCH) * PAR_STRATA + s,
              rng.integers(0, i_blk, STREAM_BATCH) + s * i_blk,
              rng.random(STREAM_BATCH).astype(np.float32))
             for _ in range(PAR_BATCHES // PAR_STRATA)]
            for s in range(PAR_STRATA)]


def strata_log(path, streams, n_parts):
    """Stratum s into partition s mod ``n_parts``, round by round."""
    log = EventLog(path, num_partitions=n_parts, fsync=False)
    for k in range(len(streams[0])):
        for s, stream in enumerate(streams):
            log.append_arrays(s % n_parts, *stream[k])
    return log


def phase_streams_parallel(scratch):
    """The 32 stratum-routed batches drained by ``ParallelIngestRunner``
    with N = 1, 2, 4 consumers on fresh models (stratum s on partition
    s mod N: every N drains the same data, and the strata commute), the
    N = 2 and 4 tables against N = 1's; a kill and resume at N = 4; one
    refresh of 4 consumers' deltas as one catalog version."""
    streams = strata(5)
    total = PAR_BATCHES * STREAM_BATCH
    cfg = stream_online_cfg()
    dcfg = StreamingDriverConfig(batch_records=STREAM_BATCH,
                                 checkpoint_every=STREAM_CKPT_EVERY)
    per_n, n1 = {}, None
    for n in PAR_CONSUMERS:
        log = strata_log(os.path.join(scratch, f"par_log{n}"), streams, n)
        model = OnlineMF(cfg)
        ck = os.path.join(scratch, f"par_ck{n}")
        runner = ParallelIngestRunner(model, log, ck, config=dcfg)
        runner.manager = TimedCheckpoints(ck)
        applied, wall = timed(runner.run)
        tele = runner.telemetry()
        if applied != PAR_BATCHES or any(tele["lag_records"].values()):
            raise AssertionError(f"N={n}: applied {applied}, lag "
                                 f"{tele['lag_records']}")
        rate = total / wall
        gate = tele.get("gate", {"grants": 0, "waits": 0})
        per_n[n] = dict(wall_s=wall, ratings_per_s=rate,
                        efficiency=rate / (n * per_n[1]["ratings_per_s"])
                        if n > 1 else 1.0,
                        gate_grants=gate["grants"], gate_waits=gate["waits"],
                        barriers=runner.checkpoints_written,
                        barrier_write_s=sum(w for w, _ in
                                            runner.manager.saves),
                        barriers_held=runner.barriers_held)
        if n1 is None:
            n1 = model
        else:
            per_n[n]["max_abs_vs_n1"] = same_tables(model, n1,
                                                    f"N={n} vs N=1")
        del model, runner
    del n1
    say("streams.parallel", batches=PAR_BATCHES, batch=STREAM_BATCH,
        strata=PAR_STRATA, **{f"n{n}": v for n, v in per_n.items()})

    # kill at N = 4 after 14 applied batches, resume on a fresh model
    log = EventLog(os.path.join(scratch, f"par_log{PAR_CONSUMERS[-1]}"),
                   num_partitions=PAR_STRATA, fsync=False)
    ck = os.path.join(scratch, "par_crash")
    applied, lock = [], threading.Lock()

    def crash(b):
        with lock:
            applied.append((b.partition, b.start_offset, b.end_offset))
            if len(applied) == PAR_CRASH_AFTER:
                raise _Crash()

    r1 = ParallelIngestRunner(OnlineMF(cfg), log, ck, config=dcfg,
                              on_batch=crash)
    try:
        r1.run()
        raise AssertionError("the N=4 crash leg did not crash")
    except _Crash:
        pass
    frontier = r1.applied_frontier()
    del r1
    m2 = OnlineMF(cfg)
    r2 = ParallelIngestRunner(m2, log, ck, config=dcfg, on_batch=lambda b:
                              applied.append((b.partition, b.start_offset,
                                              b.end_offset)))
    if not r2.resume():
        raise AssertionError("no barrier snapshot to resume from")
    bound = STREAM_CKPT_EVERY * STREAM_BATCH
    window = {p: frontier.get(p, 0) - m2.consumed_offsets.get(p, 0)
              for p in range(PAR_STRATA)}
    resume_s = timed(r2.run)[1]
    per_part = total // PAR_STRATA
    dups = {p: coverage([(lo, hi) for q, lo, hi in applied if q == p],
                        per_part, f"N=4 crash p{p}")
            for p in range(PAR_STRATA)}
    for p in range(PAR_STRATA):
        if not (dups[p] <= bound and 0 <= window[p] <= bound
                and m2.consumed_offsets[p] == per_part):
            raise AssertionError(f"p{p}: {dups[p]} records twice, window "
                                 f"{window[p]}, offset "
                                 f"{m2.consumed_offsets[p]}")

    # one refresh of 4 consumers' deltas: one version for the engine
    engine = r2.serving_engine(k=SERVE_K)
    for s in range(PAR_STRATA):
        log.append_arrays(s, *streams[s][0])  # known ids only
    r2.run()
    before = len(r2.catalog_versions)
    refresh_s = timed(r2.refresh_serving)[1]
    if (len(r2.catalog_versions) != before + 1
            or engine.stats["delta_flushes"] != 1
            or engine.stats["delta_swaps"] != 1):
        raise AssertionError(
            f"one refresh gave {len(r2.catalog_versions) - before} "
            f"versions ({engine.stats['delta_swaps']} delta swaps)")
    same_serving(engine, m2, "coalesced refresh")
    say("streams.parallel.crash", consumers=PAR_STRATA,
        crash_after_batches=PAR_CRASH_AFTER,
        duplicate_window_records=window, duplicated_records=dups,
        bound_records=bound, lost=0, resume_drain_s=resume_s,
        refresh_versions=1, refresh_s=refresh_s,
        launches=no_dsgd_launches("streams.parallel"))


def check_retrain(solver, history, fitted, holdout, label):
    """A DSGD retrain's fit on the step pair (``fitted``) against the plain
    route (``ops.sgd.dsgd_train``) on the card, from the same initial
    tables over the retrain's own problem, minibatch and schedule: each
    stratum of the first sweep at ``STRATUM_TOL`` (``check_strata``), the
    whole fit at ``STRATUM_TOL`` × sweeps × blocks, holdout RMSE within
    ``RETRAIN_RMSE_TOL``. Returns (one-stratum max-abs, fit max-abs, RMSE
    of the kernel fit, RMSE of the plain fit)."""
    cfg, upd, dev = solver.config, solver.updater, solver.device
    mb, k = cfg.minibatch_size, cfg.num_blocks or 1
    problem = blocking.block_problem(history, num_blocks=k, seed=cfg.seed,
                                     minibatch_multiple=mb,
                                     minibatch_sort=cfg.minibatch_sort)
    if not (np.array_equal(problem.users.ids, fitted.users.ids)
            and np.array_equal(problem.items.ids, fitted.items.ids)):
        raise AssertionError(f"{label}: the rebuilt problem is not the "
                             "retrain's")
    args = device_args(problem,
                       *blocking.minibatch_inv_counts(problem.ratings, mb),
                       dev)
    U0, V0 = (torch.as_tensor(t, dtype=torch.float32).to(dev)
              for t in solver._init_factors(problem))
    lr, lam = float(upd.learning_rate), float(upd.lambda_)
    one = check_strata(U0, V0, args, problem, step_plan(args, mb), lr, lam,
                       label)
    Up, Vp = sgd_ops.dsgd_train(U0, V0, *args, updater=upd, minibatch=mb,
                                num_blocks=k, iterations=cfg.iterations,
                                collision=cfg.collision_mode)
    torch.cuda.synchronize()
    err = max_abs([(fitted.U, Up), (fitted.V, Vp)])
    rmse = fitted.rmse(holdout)
    rmse_plain = MFModel(U=Up, V=Vp, users=problem.users,
                         items=problem.items).rmse(holdout)
    if not (err <= STRATUM_TOL * cfg.iterations * k
            and abs(rmse - rmse_plain) <= RETRAIN_RMSE_TOL):
        raise AssertionError(f"{label}: step pair vs plain route: max-abs "
                             f"{err:.3e}, holdout RMSE {rmse} vs "
                             f"{rmse_plain}")
    return one, err, rmse, rmse_plain


def phase_streams_adaptive(scratch):
    """``AdaptiveMF`` (rank 128; a DSGD retrain every 4 batches on a
    background thread) under a ``StreamingDriver`` over 12 batches: the
    retrains launch the step pair from their thread; the batches buffered
    during a retrain replay after its swap, and every swap moves the
    engine's catalog version; holdout RMSE against the online-only model
    on the same stream; each retrain held against the plain route on the
    card (``check_retrain``); then one foreground ALS retrain. Returns the
    launch counts of the DSGD leg."""
    batches, holdout = netflix_batches(6, ADAPT_BATCHES, ADAPT_HOLDOUT)
    log = EventLog(os.path.join(scratch, "adapt_log"), fsync=False)
    for b in batches:
        log.append(0, b)
    acfg = AdaptiveMFConfig(num_factors=128, minibatch_size=16384,
                            learning_rate=0.05, offline_every=4,
                            background=True, offline_algorithm="dsgd",
                            offline_iterations=3)
    model = AdaptiveMF(acfg)
    walls, buffered, retrains = [], [], []
    real_retrain, real_finish = model._retrain, model._finish_batch

    def retrain(history):  # on the retrain thread
        t0 = time.perf_counter()
        out = real_retrain(history)
        torch.cuda.synchronize()
        walls.append((int(history.n), time.perf_counter() - t0))
        retrains.append((history, out))
        return out

    def finish(*args):
        buffered.append(len(model._buffer))
        return real_finish(*args)

    model._retrain, model._finish_batch = retrain, finish
    drv = StreamingDriver(model, log, os.path.join(scratch, "adapt_ck"),
                          config=StreamingDriverConfig(
                              batch_records=STREAM_BATCH,
                              checkpoint_every=STREAM_CKPT_EVERY))
    engine = drv.serving_engine(k=SERVE_K)
    cuda_sgd.reset_launch_counts()
    wall = timed(lambda: (drv.run(), model.flush()))[1]
    launches = dict(cuda_sgd.LAUNCHES)
    if not (launches["sgd_item_rows_kernel"] > 0
            and launches["sgd_user_rows_kernel"] > 0):
        raise AssertionError(f"the retrains launched no step pair: "
                             f"{launches}")
    if model.retrain_count < 1 or model._buffer or model.state != "Online":
        raise AssertionError(f"{model.retrain_count} retrains, "
                             f"{len(model._buffer)} buffered, {model.state}")
    if (len(drv.catalog_versions) != 1 + model.retrain_count
            or engine.version != drv.catalog_versions[-1]):
        raise AssertionError(f"catalog versions {drv.catalog_versions} for "
                             f"{model.retrain_count} swaps")
    if model.online.consumed_offsets != {0: ADAPT_BATCHES * STREAM_BATCH}:
        raise AssertionError(f"offsets {model.online.consumed_offsets}")
    online_only = OnlineMF(OnlineMFConfig(num_factors=128, learning_rate=0.05,
                                          minibatch_size=16384))
    for b in batches:
        online_only.partial_fit(b, emit_updates=False)
    rmse_adaptive, rmse_online = model.rmse(holdout), online_only.rmse(holdout)
    if not (math.isfinite(rmse_adaptive) and math.isfinite(rmse_online)):
        raise AssertionError(f"holdout RMSE {rmse_adaptive} / {rmse_online}")
    # the retrains' kernel launches are counted above; these are not
    held = [check_retrain(model._offline_solver(), history, fitted, holdout,
                          f"streams.adaptive retrain {j}")
            for j, (history, fitted) in enumerate(retrains)]
    if len(held) != model.retrain_count:
        raise AssertionError(f"{len(held)} of {model.retrain_count} "
                             "retrains held against the plain route")
    say("streams.adaptive", batches=ADAPT_BATCHES, batch=STREAM_BATCH,
        rank=acfg.num_factors, offline_every=acfg.offline_every,
        retrains=model.retrain_count, retrain_rows=[r for r, _ in walls],
        retrain_wall_s=[w for _, w in walls], buffered_per_swap=buffered,
        catalog_versions=len(drv.catalog_versions),
        checkpoints=drv.checkpoints_written, drain_wall_s=wall,
        step_pair_launches=launches, holdout=ADAPT_HOLDOUT,
        rmse_adaptive=rmse_adaptive, rmse_online_only=rmse_online,
        retrain_one_stratum_max_abs=[h[0] for h in held],
        retrain_vs_plain_max_abs=[h[1] for h in held],
        retrain_rmse=[h[2] for h in held],
        retrain_rmse_plain=[h[3] for h in held],
        tol_per_stratum=STRATUM_TOL, tol_rmse=RETRAIN_RMSE_TOL)
    del model, drv, engine, online_only, retrains

    # one foreground ALS retrain over the same history
    als = AdaptiveMF(dataclasses.replace(acfg, offline_algorithm="als",
                                         background=False,
                                         offline_every=None))
    for b in batches:
        als.process(b)
    before = dict(cuda_sgd.LAUNCHES)
    als_s = timed(als.trigger_batch_training)[1]
    if dict(cuda_sgd.LAUNCHES) != before or als.retrain_count != 1:
        raise AssertionError("the ALS retrain launched a DSGD kernel or "
                             "did not swap")
    rmse_als = als.rmse(holdout)
    if not math.isfinite(rmse_als):
        raise AssertionError(f"ALS-retrained holdout RMSE {rmse_als}")
    say("streams.adaptive.als", history=als._history_rows,
        retrain_wall_s=als_s, rmse=rmse_als)
    return launches


# [obs.stream]: 8 clean Netflix-shaped batches and one rotten one (NaN
# ratings, out-of-range ratings, ids past the vocabulary), a foreground DSGD
# retrain every 4 batches
OBS_STREAM_BATCHES = 8
OBS_ROTTEN = dict(nan=2_000, out_of_range=5_000, out_of_vocab=12_000)
OBS_STREAM_ROUTES = ("/lineagez", "/criticalpathz", "/contentionz",
                     "/healthz")


def rotten_batch(hi):
    """One more batch of the stream's shape with rows that the quarantine
    (NaN ratings) and the data-quality gate (ratings past ``hi``, ids past
    the vocabulary) must catch."""
    u, i, r, _ = netflix_batches(22, 1)[0].to_numpy()
    u, i, r = u.copy(), i.copy(), r.copy()
    a = OBS_ROTTEN["nan"]
    b = a + OBS_ROTTEN["out_of_range"]
    c = b + OBS_ROTTEN["out_of_vocab"]
    r[:a] = np.nan
    r[a:b] = hi + 5.0
    u[b:c] = NETFLIX["num_users"] + np.arange(c - b) % 64
    return Ratings.from_arrays(u, i, r)


def stream_run(batches, run_dir, acfg, planes):
    """One ``StreamingDriver(AdaptiveMF)`` drain of ``batches`` appended to
    a fresh log under ``run_dir``, with the stream planes on (``planes``: a
    dict of the data-quality policy; they bind before the log, so the
    appends are marked) or off, then a refresh and one served request.
    Returns (model, driver, engine, drain seconds, what the planes
    hold)."""
    out = {}
    if planes is not None:
        reg, _ = obs.enable()
        recorder, _ = obs.enable_flight_recorder(
            interval_s=0.25, bundle_dir=os.path.join(run_dir, "bundles"))
        out["lineage"] = obs.enable_lineage()
        out["analyzer"] = obs.enable_disttrace()
        out["tracker"] = obs.enable_contention(interval_s=0.25)
        inspector = obs.DataQualityInspector(**planes)
        monitor = obs.HealthMonitor()
        monitor.watch_data_quality(inspector)
        inspect_s, real_inspect = [], inspector.inspect_batch

        def timed_inspect(batch):  # the gate's host wall a batch
            t0 = time.perf_counter()
            counts = real_inspect(batch)
            inspect_s.append(time.perf_counter() - t0)
            return counts

        inspector.inspect_batch = timed_inspect
        out.update(reg=reg, recorder=recorder, inspector=inspector,
                   monitor=monitor, inspect_s=inspect_s)
    log = EventLog(os.path.join(run_dir, "log"), fsync=False)
    for b in batches:
        log.append(0, b)
    model = AdaptiveMF(acfg)
    drv = StreamingDriver(model, log, os.path.join(run_dir, "ck"),
                          inspector=out.get("inspector"),
                          config=StreamingDriverConfig(
                              batch_records=STREAM_BATCH,
                              checkpoint_every=STREAM_CKPT_EVERY))
    engine = drv.serving_engine(k=SERVE_K)
    _, wall = timed(drv.run)
    drv.refresh_serving()
    engine.recommend(model.online.users.id_array()[:64])
    return model, drv, engine, wall, out


def phase_obs_stream(scratch, smi):
    """``[obs.stream]`` at ``[online]``'s width (480,189 × 17,770, rank 128,
    batches of 100,000): a ``StreamingDriver`` with ``AdaptiveMF`` (a
    foreground DSGD retrain every 4 batches: the step pair's launches,
    counted here) over 8 batches and a rotten one, with the lineage,
    critical-path and contention planes on (the flight recorder sampling)
    and a ``DataQualityInspector`` behind ``watch_data_quality``. Checks:
    the check trips CRITICAL on the rotten batch and the bundle it freezes
    validates with live ``lineage.json`` / ``contention.json``;
    ``/criticalpathz``'s samples reconcile with the lineage freshness
    histogram; the tables equal a planes-off run's at the [online] bar;
    the fleet's ``/podtracez`` answers 200. Then ``ParallelIngestRunner``
    at N = 2 (the [streams.parallel] strata) under the contention plane for
    ``/contentionz``'s serial fraction and the consumers' CPU fractions,
    and a second N = 2 run under the profiler for the card's busy share;
    the planes' cost on durable ratings/s (min of 5, interleaved). Returns
    the planes-on run's launch counts."""
    from large_scale_recommendation_tpu_torch.obs.introspect import (
        profile_trace,
    )
    from large_scale_recommendation_tpu_torch.obs.recorder import (
        validate_bundle,
    )

    phase_t0 = time.perf_counter()
    clean = netflix_batches(21, OBS_STREAM_BATCHES)
    lo = min(float(b.ratings.min()) for b in clean)
    hi = max(float(b.ratings.max()) for b in clean)
    batches = clean + [rotten_batch(hi)]
    policy = dict(rating_range=(lo - 1.0, hi + 1.0),
                  max_user_id=NETFLIX["num_users"] - 1,
                  max_item_id=NETFLIX["num_items"] - 1,
                  class_policy={"duplicate_key": (0.5, 0.9)})
    acfg = AdaptiveMFConfig(num_factors=128, minibatch_size=16384,
                            learning_rate=0.05, offline_every=4,
                            background=False, offline_algorithm="dsgd",
                            offline_iterations=3)
    records = (OBS_STREAM_BATCHES + 1) * STREAM_BATCH

    # -- 1. the planes-on run (the path whose launches are counted); it and
    # the planes-off run of 2. under deterministic(): bit-equal tables
    cuda_sgd.reset_launch_counts()
    with deterministic():
        m_on, drv, _, wall_on, p = stream_run(
            batches, os.path.join(scratch, "obs_stream_on"), acfg, policy)
    launches = dict(cuda_sgd.LAUNCHES)
    growth = [e["detail"] for e in obs.get_events().events(
        "online.table_growth")]
    batch_hist = p["reg"].histogram("online_batch_s")
    online_batches = p["reg"].counter("online_batches_total").value
    report = p["monitor"].run()  # CRITICAL: the recorder freezes a bundle
    server = obs.ObsServer(monitor=p["monitor"]).start()
    fleet = obs.FleetServer(obs.FleetAggregator([server.url],
                                                timeout_s=10.0)).start()
    try:
        scrapes = {rt: http_get(server.url + rt, timeout=10.0)
                   for rt in OBS_STREAM_ROUTES}
        pod_code, pod_body = http_get(fleet.url + "/podtracez?limit=512",
                                      timeout=30.0)
    finally:
        fleet.stop()
        server.stop()
    crit = json.loads(scrapes["/criticalpathz"][1])
    hist = [m for m in p["reg"].snapshot()["metrics"]
            if m["name"] == "lineage_ingest_to_servable_s"]
    samples = crit["samples"]
    lags = [x["swap_lag_s"] for x in samples]
    bundle = p["recorder"].last_bundle
    manifest = validate_bundle(bundle) if bundle else None
    docs = obs.load_bundle(bundle) if bundle else {}
    dq = p["inspector"].snapshot()
    versions = list(drv.catalog_versions)
    obs.disable()

    # -- 2. the planes-off run: the same tables, bit for bit
    with deterministic():
        m_off, _, _, wall_off, _ = stream_run(
            batches, os.path.join(scratch, "obs_stream_off"), acfg, None)
    table_err = same_tables(m_on.online, m_off.online, "obs.stream on/off",
                            tol=dict(rtol=0.0, atol=0.0))
    caps = (m_on.online.users.capacity, m_on.online.items.capacity)
    del m_on, m_off, drv

    say("obs.stream", card=smi, batches=OBS_STREAM_BATCHES + 1,
        batch=STREAM_BATCH, rank=acfg.num_factors, rotten=OBS_ROTTEN,
        dq_violations=dq["violations"], dq_status=dq["status"],
        health=report["status"],
        data_quality_check=report["checks"]["data_quality"]["status"],
        bundle=os.path.basename(bundle) if bundle else None,
        bundle_trigger=manifest["trigger"] if manifest else None,
        bundle_lineage_records=len(docs.get("lineage", {}).get(
            "lineage", {}).get("records", [])),
        bundle_contention_locks=len(docs.get("contention", {}).get(
            "locks", [])),
        catalog_versions=len(versions), launches=launches,
        critical_path={k: v["mean_s"] for k, v in crit["stages"].items()},
        critical_samples=len(samples),
        freshness_hist_count=hist[0]["count"] if hist else None,
        freshness_hist_mean_s=hist[0]["mean"] if hist else None,
        swap_lag_mean_s=(sum(lags) / len(lags)) if lags else None,
        scrape_codes={rt: c for rt, (c, _) in scrapes.items()},
        podtracez=pod_code, tables_max_abs_on_vs_off=table_err,
        drain_s_on=wall_on, drain_s_off=wall_off,
        inspect_ms_per_batch=[t * 1e3 for t in p["inspect_s"]],
        growth_events=len(growth),
        last_growth=growth[-1] if growth else None, capacities=caps,
        online_batches_total=online_batches,
        online_batch_s_count=batch_hist.count,
        online_batch_s_p50_ms=batch_hist.quantile(0.5) * 1e3)
    if not (growth and (growth[-1]["users_capacity"],
                        growth[-1]["items_capacity"]) == caps
            and online_batches > 0 and batch_hist.count == online_batches):
        raise AssertionError(f"obs.stream: growth events {growth[-1:]} vs "
                             f"capacities {caps}; {online_batches} batches, "
                             f"{batch_hist.count} observed")
    if not (launches["sgd_item_rows_kernel"] > 0
            and launches["sgd_user_rows_kernel"] > 0):
        raise AssertionError(f"obs.stream: no step-pair launches {launches}")
    if (report["checks"]["data_quality"]["status"] != obs.CRITICAL
            or dq["violations"]["out_of_vocab"] != OBS_ROTTEN["out_of_vocab"]
            or dq["violations"]["out_of_range"] != OBS_ROTTEN["out_of_range"]
            or dq["violations"]["non_finite"] != 0):
        raise AssertionError(f"obs.stream: data quality {dq}, health "
                             f"{report['status']}")
    if (manifest is None or manifest["trigger"] != "health_critical"
            or not docs["lineage"]["lineage"]["records"]
            or "note" in docs["contention"]
            or not docs["contention"]["locks"]):
        raise AssertionError(f"obs.stream: the trip's bundle {bundle} "
                             f"({manifest})")
    if not (samples and hist and hist[0]["count"] == len(samples)
            and abs(sum(lags) / len(lags) - hist[0]["mean"])
            <= 1e-9 * max(1.0, hist[0]["mean"])):
        raise AssertionError(f"obs.stream: {len(samples)} critical-path "
                             f"samples vs the freshness histogram {hist}")
    for x in samples:
        parts = [x[k] for k in ("queue_wait_s", "train_apply_s",
                                "swap_lag_s") if x[k] is not None]
        if abs(math.fsum(parts) - x["total_s"]) > 1e-9:
            raise AssertionError(f"obs.stream: sample {x} stages do not "
                                 "sum to its total")
    codes = {rt: c for rt, (c, _) in scrapes.items()}
    want = {rt: 503 if rt == "/healthz" else 200 for rt in codes}
    if codes != want or pod_code != 200:  # /healthz: the CRITICAL trip
        raise AssertionError(f"obs.stream: scrapes {codes}, /podtracez "
                             f"{pod_code}")
    obs.validate_chrome_trace(json.loads(pod_body))

    # -- 3. N = 2 consumers under the contention plane, then the profiler
    streams = strata(5)
    cfg = stream_online_cfg()
    dcfg = StreamingDriverConfig(batch_records=STREAM_BATCH,
                                 checkpoint_every=STREAM_CKPT_EVERY)
    def contention_run(tag, hooks):
        obs.enable()
        tracker = obs.enable_contention(interval_s=0.25)
        par_log = strata_log(os.path.join(scratch, f"obs_par_log{tag}"),
                             streams, 2)
        reg = obs.get_registry()
        if not hooks:  # the model's instruments bound to the null registry
            obs.set_registry(obs_registry.NULL_REGISTRY)
        model = OnlineMF(cfg)
        obs.set_registry(reg)
        runner = ParallelIngestRunner(
            model, par_log, os.path.join(scratch, f"obs_par_ck{tag}"),
            config=dcfg)
        tracker.reset_window()
        _, wall = timed(runner.run)
        server = obs.ObsServer().start()
        try:
            code, body = http_get(server.url + "/contentionz", timeout=10.0)
        finally:
            server.stop()
        obs.disable()
        if code != 200:
            raise AssertionError(f"obs.stream: /contentionz {code}")
        return json.loads(body), wall

    def apply_lock(cz):
        return next(((r["contended"], r["wait_s"], r["hold_s"])
                     for r in cz["top_contended"]
                     if r["lock"] == "online.apply_lock"), None)

    # the online model's hooks (the batch histogram's wait) on, then off
    cz, par_wall = contention_run("", True)
    cz_off, par_wall_off = contention_run("_nohooks", False)
    cpu_frac = {pt: row["busy_s"] / cz["window"]["wall_s"]
                for pt, row in cz["partitions"].items()}
    prof_log = strata_log(os.path.join(scratch, "obs_par_log_p"), streams, 2)
    prof_runner = ParallelIngestRunner(OnlineMF(cfg), prof_log,
                                       os.path.join(scratch, "obs_par_ck_p"),
                                       config=dcfg)
    prof_dir = os.path.join(scratch, "obs_par_profile")
    with profile_trace(prof_dir):
        _, prof_wall = timed(prof_runner.run)
    busy_ms, window_ms, _ = device_busy(os.path.join(prof_dir, TRACE_FILE))
    del prof_runner
    say("obs.stream.contention", card=smi, consumers=cz["consumers"],
        wall_s=par_wall, serial_fraction=cz["serial_fraction"],
        efficiency=cz["efficiency"], cpu_source=cz["cpu_source"],
        projected_speedup_at_2n=cz["projected_speedup_at_2n"],
        consumer_cpu_frac=cpu_frac,
        top_contended=[(r["lock"], r["contended"], r["wait_s"], r["hold_s"])
                       for r in cz["top_contended"][:5]],
        lock_wait_s_total=cz["lock_wait_s_total"],
        apply_lock_contended_wait_hold_s=apply_lock(cz),
        hooks_off_wall_s=par_wall_off,
        hooks_off_serial_fraction=cz_off["serial_fraction"],
        hooks_off_efficiency=cz_off["efficiency"],
        hooks_off_apply_lock_contended_wait_hold_s=apply_lock(cz_off),
        profiled_wall_s=prof_wall, device_busy_ms=busy_ms,
        device_window_ms=window_ms, device_busy_share=busy_ms / window_ms,
        device_busy_over_wall=busy_ms / (prof_wall * 1e3))
    if cz["consumers"] != 2 or cz["serial_fraction"] is None:
        raise AssertionError(f"obs.stream: /contentionz {cz}")

    # -- 4. the planes' cost on durable ratings/s, interleaved off / on
    walls_on, walls_off, inspect_on = [], [], []
    for j in range(5):
        walls_off.append(stream_run(
            batches, os.path.join(scratch, f"obs_cost_off{j}"), acfg,
            None)[3])
        run_on = stream_run(batches, os.path.join(scratch, f"obs_cost_on{j}"),
                            acfg, policy)
        walls_on.append(run_on[3])
        inspect_on.append(sum(run_on[4]["inspect_s"]))
        obs.disable()
    say("obs.stream.cost", card=smi, runs_each=5, records=records,
        drain_s_on=walls_on, drain_s_off=walls_off,
        ratings_per_s_on=records / min(walls_on),
        ratings_per_s_off=records / min(walls_off),
        on_over_off_ratings_per_s=min(walls_off) / min(walls_on),
        inspect_s_per_run_on=inspect_on,
        phase_wall_s=time.perf_counter() - phase_t0)
    return launches


def phase_streams(scratch):
    """The four stream phases; returns the adaptive leg's launch counts."""
    cuda_sgd.reset_launch_counts()
    phase_streams_log(scratch)
    phase_streams_driver(scratch)
    phase_streams_parallel(scratch)
    return phase_streams_adaptive(scratch)


# -- the parameter server, the pipeline and the tiered store (host threads
# and torch ops on the card; the pipeline's DSGD runs the step pair) ---------

# bench.py:1007-1041 (PS offline) and :1052-1086 (PS online + batch), at
# [online]'s Netflix width and rank
PS_RATINGS, PS_CHECK_RATINGS = 2_000_000, 200_000
PS_CFG = dict(num_factors=128, iterations=2, learning_rate=0.05,
              lr_schedule="inverse_sqrt", worker_parallelism=4,
              ps_parallelism=4, pull_limit=4, chunk_size=2048,
              minibatch_size=4096)
PS_AD_EVENTS, PS_AD_CHECK_EVENTS, PS_AD_HOLDOUT = 400_000, 100_000, 50_000
PS_AD_CFG = dict(num_factors=128, iterations=2, learning_rate=0.05,
                 lr_schedule="inverse_sqrt", worker_parallelism=4,
                 ps_parallelism=4, chunk_size=4096, minibatch_size=4096,
                 online_chunk_size=4096)
PIPE_RATINGS, PIPE_PAIRS = 2_000_000, 65_536
# scripts/streams_bench.py:282-285 (TIERED_r01.json's geometry)
TIER = dict(num_users=1_000_000, num_items=4_000, rank=32, n_batches=24,
            batch_records=20_000, slot_capacity=8_192, zipf_s=1.25,
            checkpoint_every=8, queue_capacity=2, serve_requests=16)
TIER_CRASH_AFTER = 12


def cat_ratings(parts):
    return Ratings.from_arrays(*(np.concatenate(a) for a in
                                 zip(*(p.to_numpy() for p in parts))))


def take(r, idx):
    return Ratings.from_arrays(*(a[idx] for a in r.to_numpy()))


def ps_netflix(n, seed):
    """``n`` Netflix-shaped ratings (``netflix_batches``) split 95/5 by a
    seeded permutation: (train, holdout)."""
    r = cat_ratings(netflix_batches(seed, n // STREAM_BATCH))
    perm = np.random.default_rng(seed).permutation(r.n)
    return take(r, np.sort(perm[r.n // 20:])), take(r, np.sort(perm[:r.n
                                                                   // 20]))


def same_factor_dicts(a, b, label, tol=ONLINE_TOL) -> float:
    """Two id → vector dicts hold the same ids with vectors within
    ``tol``; returns the largest difference."""
    if sorted(a) != sorted(b):
        raise AssertionError(f"{label}: id sets differ")
    keys = sorted(a)
    x = np.stack([a[k] for k in keys])
    y = np.stack([b[k] for k in keys])
    if not np.allclose(x, y, **tol) or not np.isfinite(x).all():
        raise AssertionError(f"{label}: factors beyond {tol}")
    return float(np.abs(x - y).max())


def untrained_rmse(solver, data, scale):
    """Holdout RMSE of the initial keyed rows over the pairs the trained
    model scores (its known users and items)."""
    ru, ri, rv, _ = data.to_numpy()
    _, seen = solver.predict(ru, ri, return_mask=True)
    init = PseudoRandomFactorInitializer(solver.config.num_factors,
                                         scale=scale)
    pred = (init(ru[seen].astype(np.int64)).numpy()
            * init(ri[seen].astype(np.int64)).numpy()).sum(1)
    return float(np.sqrt(np.mean((rv[seen] - pred) ** 2)))


class _CountingShard(ps_server.SimplePSLogic):
    """``SimplePSLogic`` counting pulls and pushes and timing the pushes'
    merge (``np.add.at``) on the shard threads."""

    lock = threading.Lock()
    pulls = pushes = 0
    push_s = 0.0

    def on_pull(self, ids):
        with _CountingShard.lock:
            _CountingShard.pulls += 1
        return super().on_pull(ids)

    def on_push(self, ids, deltas, outputs, worker_id=-1):
        t0 = time.perf_counter()
        super().on_push(ids, deltas, outputs, worker_id)
        with _CountingShard.lock:
            _CountingShard.pushes += 1
            _CountingShard.push_s += time.perf_counter() - t0


def ps_answer_parts(cfg, train, dev):
    """One pull answer of a one-worker ``_MFWorkerLogic`` on ``train``
    (its first chunk), each step synchronized: the user rows' ``ensure``,
    host → card staging (minibatch streams and the pulled chunk),
    ``online_train`` (host wall beside CUDA-event time), the card → host
    delta, the shard's merge."""
    worker = ps_mf._MFWorkerLogic(cfg, 0, device=dev)

    class Pulls:
        def __init__(self):
            self.ids = []

        def pull(self, ids):
            self.ids.append(ids)

    client = Pulls()
    ru, ri, rv, _ = train.to_numpy()
    for x in zip(ru.tolist(), ri.tolist(), rv.tolist()):
        worker.on_recv(x, client)
    worker.on_input_end(client)
    shard = ps_server.SimplePSLogic(PseudoRandomFactorInitializer(
        cfg.num_factors, scale=cfg.init_scale), emit_updates=False)
    items = client.ids[0]
    V_chunk = shard.on_pull(items)
    us, ips, vals = worker._data_by_chunk[int(items[0])]
    u_rows, ensure_s = timed(lambda: worker.users.ensure(us))
    mb = cfg.minibatch_size
    host = [*sgd_ops.pad_minibatches(u_rows, ips, vals, mb), V_chunk]
    staged, h2d_s = timed(lambda: [torch.from_numpy(a).to(dev)
                                   for a in host])
    a, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    (_, V_new), train_s = timed(lambda: sgd_ops.online_train(
        worker.users.array, staged[4], *staged[:4], updater=worker.updater,
        minibatch=mb, iterations=1))
    e.record()
    e.synchronize()
    delta, d2h_s = timed(lambda: (V_new - staged[4]).cpu().numpy())
    t0 = time.perf_counter()
    shard.on_push(items, delta, [])
    push_s = time.perf_counter() - t0
    return dict(chunk_items=len(items), chunk_ratings=len(us),
                ensure_s=ensure_s, h2d_s=h2d_s,
                h2d_bytes=sum(x.nbytes for x in host),
                online_train_s=train_s,
                online_train_device_ms=a.elapsed_time(e), d2h_s=d2h_s,
                d2h_bytes=delta.nbytes, shard_add_at_s=push_s)


def phase_ps_offline(dev):
    """``PSOfflineMF`` at bench.py's PS settings on 2,000,000 Netflix-shaped
    ratings (95/5): 4 worker threads train their user tables on the card, 4
    host shards merge the item deltas. A one-worker, one-shard run on
    200,000 of them (a deterministic topology) on the card and on the CPU
    within the [online] bar; one answer split into its parts."""
    train, hold = ps_netflix(PS_RATINGS, seed=7)
    cfg = PSOfflineMFConfig(**PS_CFG)
    solver = PSOfflineMF(cfg)
    real_shard = ps_mf.SimplePSLogic
    ps_mf.SimplePSLogic = _CountingShard
    try:
        (users, items), wall = timed(lambda: solver.offline(train))
    finally:
        ps_mf.SimplePSLogic = real_shard
    rmse = solver.rmse(hold)
    rmse0 = untrained_rmse(solver, hold, cfg.init_scale)
    if not (math.isfinite(rmse) and rmse < rmse0):
        raise AssertionError(f"PS offline holdout RMSE {rmse} (untrained "
                             f"{rmse0})")
    sub = take(train, np.arange(PS_CHECK_RATINGS))
    one = PSOfflineMFConfig(**dict(PS_CFG, worker_parallelism=1,
                                   ps_parallelism=1))
    card = PSOfflineMF(one)
    card_s = timed(lambda: card.offline(sub))[1]
    cpu = PSOfflineMF(one, device="cpu")
    cpu.offline(sub)
    worst = max(same_factor_dicts(card.user_factors, cpu.user_factors,
                                  "ps.offline users"),
                same_factor_dicts(card.item_factors, cpu.item_factors,
                                  "ps.offline items"))
    parts = ps_answer_parts(one, sub, dev)
    say("ps.offline", ratings=train.n, holdout=hold.n, rank=cfg.num_factors,
        workers=cfg.worker_parallelism, shards=cfg.ps_parallelism,
        pull_limit=cfg.pull_limit, chunk=cfg.chunk_size,
        iterations=cfg.iterations, wall_s=wall,
        ratings_per_s=train.n * cfg.iterations / wall,
        pulls=_CountingShard.pulls, pushes=_CountingShard.pushes,
        shard_push_s=_CountingShard.push_s, users=len(users),
        items=len(items), rmse=rmse, rmse_untrained=rmse0,
        w1_ratings=sub.n, w1_card_wall_s=card_s,
        w1_card_vs_cpu_max_abs=worst, tol=ONLINE_TOL)
    say("ps.offline.parts", **parts)


class _SyncClient:
    """One worker and one shard in one thread: pushes and controls reach
    the shard at once, pulls wait in a FIFO (a deterministic topology)."""

    def __init__(self, shard):
        self.shard, self.pending, self.rid = shard, collections.deque(), 0

    def pull(self, ids):
        self.pending.append((self.rid, np.asarray(ids, np.int64)))
        self.rid += 1

    def push(self, ids, deltas):
        self.shard.on_push(ids, deltas, [], worker_id=0)

    def control(self, shard_id, payload):
        self.shard.on_control(0, payload, [])

    def output(self, value):
        pass


def ps_sync_run(cfg, evs, dev, lag=2):
    """``evs`` through one ``OnlineBatchWorkerLogic`` on ``dev`` and one
    ``AdaptivePSLogic``, answering pulls in FIFO order with at most ``lag``
    in flight after each event."""
    worker = ps_adaptive.OnlineBatchWorkerLogic(cfg, 0, device=dev)
    shard = ps_adaptive.AdaptivePSLogic(PseudoRandomFactorInitializer(
        cfg.num_factors, scale=cfg.init_scale), 1)
    client = _SyncClient(shard)

    def pump(keep):
        while len(client.pending) > keep:
            rid, ids = client.pending.popleft()
            worker.on_pull_answer(ps_core.PullAnswer(
                ids, shard.on_pull(ids), request_id=rid), client)

    for ev in evs:
        worker.on_recv(ev, client)
        pump(lag)
    worker.on_input_end(client)
    pump(0)
    return worker, shard


def ps_events(r, trigger_at=None):
    ru, ri, rv, _ = r.to_numpy()
    evs = list(zip(ru.tolist(), ri.tolist(), rv.tolist()))
    if trigger_at is not None:
        evs.insert(trigger_at, BATCH_TRIGGER)
    return evs


def phase_ps_adaptive(dev):
    """``PSOnlineBatchMF`` at bench.py's settings: 400,000 Netflix-shaped
    events with one ``BATCH_TRIGGER`` at the middle through 4 workers and 4
    shards (chunked online path on the host, the batch replay on the card);
    the same stream without the trigger; the one-worker replay on the card
    and on the CPU (a deterministic single-thread drive) within the
    [online] bar."""
    batches, hold = netflix_batches(8, PS_AD_EVENTS // STREAM_BATCH,
                                    PS_AD_HOLDOUT)
    r = cat_ratings(batches)
    cfg = PSOnlineBatchConfig(**PS_AD_CFG)
    marks = []
    W = ps_adaptive.OnlineBatchWorkerLogic
    real_start, real_finish = W._start_batch, W._finish_batch

    def start(self, ps):
        marks.append(("start", time.perf_counter()))
        return real_start(self, ps)

    def finish(self, ps):
        torch.cuda.synchronize()
        marks.append(("end", time.perf_counter()))
        return real_finish(self, ps)

    W._start_batch, W._finish_batch = start, finish
    try:
        solver = PSOnlineBatchMF(cfg)
        wall = timed(lambda: solver.run(ps_events(r, r.n // 2)))[1]
    finally:
        W._start_batch, W._finish_batch = real_start, real_finish
    runs = sum(w.batches_run for w in solver.workers)
    if runs != cfg.worker_parallelism or not all(
            s.state == "online" and s.batches_seen == 1
            for s in solver.store.shards):
        raise AssertionError(f"{runs} batches run; shards "
                             f"{[s.state for s in solver.store.shards]}")
    replay_s = (max(t for k, t in marks if k == "end")
                - min(t for k, t in marks if k == "start"))
    online = PSOnlineBatchMF(cfg)
    online_s = timed(lambda: online.run(ps_events(r)))[1]
    rmse, rmse_online = solver.rmse(hold), online.rmse(hold)
    if not (math.isfinite(rmse) and rmse < rmse_online):
        raise AssertionError(f"holdout RMSE with the trigger {rmse}, online "
                             f"only {rmse_online}")
    sub = take(r, np.arange(PS_AD_CHECK_EVENTS))
    one = PSOnlineBatchConfig(**dict(PS_AD_CFG, worker_parallelism=1,
                                     ps_parallelism=1))
    evs = ps_events(sub, sub.n // 2)
    (cw, cs), card_s = timed(lambda: ps_sync_run(one, evs, dev))
    pw, psh = ps_sync_run(one, evs, torch.device("cpu"))
    if not (cw.batches_run == pw.batches_run == 1):
        raise AssertionError("the one-worker drive ran no replay")
    worst = max(same_factor_dicts(cw.users, pw.users, "ps.adaptive users"),
                same_factor_dicts(cs.snapshot(), psh.snapshot(),
                                  "ps.adaptive items"))
    say("ps.adaptive", events=r.n, rank=cfg.num_factors,
        workers=cfg.worker_parallelism, shards=cfg.ps_parallelism,
        chunk=cfg.chunk_size, online_chunk=cfg.online_chunk_size,
        iterations=cfg.iterations, wall_s=wall, events_per_s=r.n / wall,
        replay_wall_s=replay_s, batches_run=runs,
        online_only_wall_s=online_s,
        online_only_events_per_s=r.n / online_s, holdout=hold.n,
        rmse=rmse, rmse_online_only=rmse_online, w1_events=sub.n,
        w1_card_wall_s=card_s, w1_card_vs_cpu_max_abs=worst, tol=ONLINE_TOL)


def phase_pipeline(train, holdout, dev):
    """``Pipeline(IdCompactor(), MeanCenterer(), DSGD(cfg))`` on 2,000,000
    of the [main] train ratings at the [main] config (k 8, rank 128,
    minibatch 32,768, 3 sweeps): its predictions on 65,536 holdout pairs
    bit-equal to the same stages composed by hand on the card (the step
    pair has no atomics), its strata held against the plain route, and
    every stratum step launching both kernels. Returns the pipeline fit's
    launch counts."""
    cfg = dataclasses.replace(DSGDConfig(**BENCH), num_blocks=K)
    mb = cfg.minibatch_size
    sub = take(train, np.arange(PIPE_RATINGS))
    hu, hi, hv, _ = (a[:PIPE_PAIRS] for a in holdout.to_numpy())
    cuda_sgd.reset_launch_counts()
    pm, wall = timed(lambda: Pipeline(IdCompactor(), MeanCenterer(),
                                      DSGD(cfg)).fit(sub))
    launches = dict(cuda_sgd.LAUNCHES)
    fc = IdCompactor().fit(sub)
    fm = MeanCenterer().fit(fc.transform(sub))
    data = fm.transform(fc.transform(sub))
    manual = DSGD(cfg).fit(data)
    got = pm.predict(hu, hi)
    want = manual.predict(*fc.map_ids(hu, hi)) + np.float32(fm.mean)
    if not (np.array_equal(got, want) and np.isfinite(got).all()):
        raise AssertionError("pipeline predictions differ from the manual "
                             "composition's")
    problem = blocking.block_problem(data, num_blocks=K, seed=cfg.seed,
                                     minibatch_multiple=mb,
                                     minibatch_sort=cfg.minibatch_sort)
    if not (np.array_equal(problem.users.ids, pm.model.users.ids)
            and np.array_equal(problem.items.ids, pm.model.items.ids)):
        raise AssertionError("pipeline: the rebuilt problem is not the fit's")
    check_launches(launches, problem.ratings.u_rows.shape[-1] // mb,
                   cfg.iterations)
    args = device_args(problem,
                       *blocking.minibatch_inv_counts(problem.ratings, mb),
                       dev)
    U0, V0 = (t.to(dev) for t in DSGD(cfg)._init_factors(problem))
    sched = schedule_from_name(cfg.lr_schedule, cfg.lambda_)
    one = check_strata(U0, V0, args, problem, step_plan(args, mb),
                       sched(cfg.learning_rate, 1), cfg.lambda_, "pipeline")
    rmse = float(np.sqrt(np.mean((got - hv) ** 2)))
    say("pipeline", ratings=sub.n, users=fc.num_users, items=fc.num_items,
        mean=fm.mean, k=K, rank=cfg.num_factors, minibatch=mb,
        sweeps=cfg.iterations, wall_s=wall, holdout_pairs=len(hu),
        rmse=rmse, bit_equal_to_manual=True, launches=launches,
        one_stratum_max_abs=f"{one:.3e}", tol_per_stratum=STRATUM_TOL)
    return launches


def zipf_batches(num_users, num_items, n_batches, batch_records, seed,
                 zipf_s):
    """scripts/streams_bench.py's bounded-Zipf stream: (batches, warm)."""
    rng = np.random.default_rng(seed)
    p = np.arange(1, num_users + 1, dtype=np.float64) ** -zipf_s
    p /= p.sum()

    def draw():
        return Ratings.from_arrays(
            rng.choice(num_users, size=batch_records, p=p),
            rng.integers(0, num_items, batch_records),
            rng.uniform(1.0, 5.0, batch_records).astype(np.float32))

    return [draw() for _ in range(n_batches)], draw()


def tier_gbs(st, n_rows, reps=5):
    """(host → card, card → host) GB/s of the store's own copies of
    ``n_rows`` pool rows: the staged side-stream load and the pinned
    write-back, each synchronized."""
    rows = np.arange(n_rows, dtype=np.int64)
    slots = np.arange(n_rows, dtype=np.int64)
    nbytes = n_rows * st.rank * 4
    with st._lock:
        pool = st._pool
        st._write_pool(slots, rows)  # warm
        h2d = timed(lambda: [st._write_pool(slots, rows)
                             for _ in range(reps)])[1] / reps
        d2h = timed(lambda: [st._gather_pool(slots)
                             for _ in range(reps)])[1] / reps
        st._pool = pool
    return nbytes / h2d / 1e9, nbytes / d2h / 1e9


def phase_store_tiered(scratch, dev):
    """TIERED_r01.json's geometry on the card: one Zipf(1.25) WAL over a
    1,000,000-id universe drained by ``StreamingDriver`` twice, all-HBM and
    tiered (8,192 device slots, the prefetcher on the feeder's lookahead);
    final user tables within the [online] bar; the engine on the store
    against the all-HBM engine (tie-aware); a crash mid-stream and a
    ``resume()`` that re-warms the hot set and drains to the same tables;
    an overcommitted pool raises on the card."""
    t = TIER
    batches, warm = zipf_batches(t["num_users"], t["num_items"],
                                 t["n_batches"], t["batch_records"], 0,
                                 t["zipf_s"])
    total = t["n_batches"] * t["batch_records"]
    cfg = OnlineMFConfig(num_factors=t["rank"], learning_rate=0.05,
                         minibatch_size=min(16384, t["batch_records"]),
                         init_capacity=1 << 15)
    log = EventLog(os.path.join(scratch, "tier_log"), fsync=False)
    _, warm_end = log.append(0, warm)
    for b in batches:
        log.append(0, b)

    def make(tiered):
        m = OnlineMF(cfg)
        if tiered:
            m.users = TieredFactorStore(
                PseudoRandomFactorInitializer(cfg.num_factors,
                                              scale=cfg.init_scale),
                capacity=cfg.init_capacity,
                slot_capacity=t["slot_capacity"])
        return m

    def driver(m, name, on_batch=None):
        return StreamingDriver(m, log, os.path.join(scratch, name),
                               on_batch=on_batch,
                               config=StreamingDriverConfig(
                                   batch_records=t["batch_records"],
                                   checkpoint_every=t["checkpoint_every"],
                                   queue_capacity=t["queue_capacity"]))

    def drive(m, name, on_batch=None):
        m.partial_fit(warm, emit_updates=False)
        if hasattr(m.users, "stats"):  # the warm batch is set-up
            m.users.stats = StoreStats()
        drv = driver(m, name, on_batch)
        m.consumed_offsets[0] = warm_end
        return drv, timed(drv.run)[1]

    hbm = make(False)
    _, hbm_s = drive(hbm, "tier_hbm")
    tier = make(True)
    drv, tier_s = drive(tier, "tier_tiered")
    st = tier.users
    s = st.stats
    rows = st.num_rows
    if rows != hbm.users.num_rows or not np.array_equal(
            st.id_array(), hbm.users.id_array()):
        raise AssertionError("tiered rows differ from the all-HBM run's")
    got, want = st.full_table()[:rows], hbm.users.array[:rows]
    if not torch.allclose(got, want, **ONLINE_TOL):
        raise AssertionError(f"tiered vs all-HBM user tables beyond "
                             f"{ONLINE_TOL}")
    worst = float((got - want).abs().max())
    pf = drv._last_stats["prefetch"]
    row_b = st.rank * 4
    h2d_bytes = (s.misses + s.installs + s.prefetched) * row_b
    d2h_bytes = s.writebacks * row_b
    h2d_gbs, d2h_gbs = tier_gbs(st, st.slot_capacity)
    # serving: the engine on the store against the all-HBM engine
    rng = np.random.default_rng(1)
    reqs = [rng.integers(0, rows, 64).astype(np.int64)
            for _ in range(t["serve_requests"])]
    eng_h = ServingEngine(hbm.to_model(), k=SERVE_K)
    eng_t = ServingEngine(tier.to_model(), k=SERVE_K, user_store=st)
    res_h, serve_h = timed(lambda: eng_h.serve(reqs))
    res_t, serve_t = timed(lambda: eng_t.serve(reqs))
    diff, compared, differ = 0.0, 0, 0
    for a, b in zip(res_t, res_h):
        if not np.array_equal(a[0] < 0, b[0] < 0):
            raise AssertionError("store-backed engine: unknown users differ")
        d, c, n_diff = topk_mismatches(a[0], a[1], b[0], b[1])
        diff, compared, differ = max(diff, d), compared + c, differ + n_diff
    if diff > SCORE_TOL or differ:
        raise AssertionError(f"store-backed lists: scores {diff:.2e}, "
                             f"{differ} of {compared} ids differ")
    # a crash mid-stream: a fresh tiered model resumes from the last
    # checkpoint with its hot set re-warmed, and drains to the same tables
    seen = []

    def crash(batch):
        seen.append(batch.end_offset)
        if len(seen) == TIER_CRASH_AFTER:
            raise _Crash("simulated consumer crash")

    try:
        drive(make(True), "tier_crash", on_batch=crash)
        raise AssertionError("the crash leg did not crash")
    except _Crash:
        pass
    saved = CheckpointManager(os.path.join(scratch, "tier_crash")).restore()
    # the resume leg with obs on: the store's gauges bind at construction,
    # a recorder samples them, /storez serves the store's snapshot
    reg, _ = obs.enable()
    recorder = obs.FlightRecorder(registry=reg)
    fresh = make(True)
    drv2 = driver(fresh, "tier_crash")
    restore_s = timed(drv2.resume)[1]
    hot = set(fresh.users.resident_rows().tolist())
    if hot != set(saved["user_hot_rows"].tolist()) or not hot:
        raise AssertionError("the restore did not re-warm the hot set")
    recorder.sample()
    replayed = drv2.run()
    storez = store_plane(fresh.users, reg, recorder)
    obs.disable()
    if not (fresh.consumed_offsets[0] == log.end_offset(0)
            and np.array_equal(fresh.users.id_array(), st.id_array())
            and torch.allclose(fresh.users.full_table()[:rows],
                               st.full_table()[:rows], **ONLINE_TOL)):
        raise AssertionError("the resumed tiered run lost records or "
                             "differs from the uninterrupted one")
    small = TieredFactorStore(PseudoRandomFactorInitializer(cfg.num_factors),
                              slot_capacity=64)
    try:
        small.acquire_rows(np.arange(100))
        raise AssertionError("an overcommitted pool did not raise")
    except RuntimeError as e:
        if "overcommitted" not in str(e):
            raise
    if small.snapshot()["hot"]["pinned"]:
        raise AssertionError("the overcommit leaked pins")
    say("store.tiered", ratings=total, batches=t["n_batches"],
        rank=t["rank"], slot_capacity=st.slot_capacity, user_rows=rows,
        device_budget_x=rows / st.slot_capacity,
        hbm_ratings_per_s=total / hbm_s,
        tiered_ratings_per_s=total / tier_s, retention=hbm_s / tier_s,
        hit_rate=s.hit_rate, hits=s.hits, misses=s.misses,
        installs=s.installs, evictions=s.evictions, writebacks=s.writebacks,
        prefetched=s.prefetched, prefetch=pf,
        demand_fault_s=s.demand_fault_s, h2d_bytes=h2d_bytes,
        d2h_bytes=d2h_bytes, h2d_gbs=h2d_gbs, d2h_gbs=d2h_gbs,
        gbs_rows=st.slot_capacity, tables_max_abs=worst, tol=ONLINE_TOL,
        serve_hbm_wall_s=serve_h, serve_tiered_wall_s=serve_t,
        serve_hits=s.serve_hits, serve_misses=s.serve_misses,
        serve_max_score_diff=diff, serve_ids_compared=compared,
        crash_after=TIER_CRASH_AFTER, restore_s=restore_s,
        rewarmed_rows=len(hot), resumed_batches=replayed,
        overcommit_raises=True, storez=storez)
    log.close()


def store_plane(store, reg, recorder):
    """``/storez`` against the store's own ``snapshot()``, the
    ``tier_host_bytes`` series and ``watch_store_memory``'s verdict, the
    store idle: 8 more samples of its plateau (the growth check clears a
    cold tier that stopped doubling)."""
    server = obs.ObsServer(registry=reg, recorder=recorder).start()
    try:
        code, body = http_get(server.url + "/storez", timeout=5.0)
    finally:
        server.stop()
    want = json.loads(json.dumps(store.snapshot()))
    if code != 200 or json.loads(body) != want:
        raise AssertionError(f"/storez answered {code}: {body[:300]}")
    for _ in range(8):
        recorder.sample()
    monitor = obs.HealthMonitor(registry=reg)
    monitor.watch_store_memory(recorder)
    check = monitor.run()["checks"]["store_memory"]
    points = recorder.series_values("tier_host_bytes")
    if not points or check["status"] != obs.OK:
        raise AssertionError(f"tier_host_bytes {points}, store_memory "
                             f"{check}")
    return {"storez_equals_snapshot": True, "host_bytes_points": points,
            "store_memory": check["status"],
            "store_memory_detail": check["detail"]}


def phase_ps_store(scratch, dev):
    """The PS phases and the tiered store; none launches a DSGD kernel."""
    cuda_sgd.reset_launch_counts()
    phase_ps_offline(dev)
    phase_ps_adaptive(dev)
    phase_store_tiered(scratch, dev)
    no_dsgd_launches("ps and store")


# -- the mesh (phases 24-27) ------------------------------------------------


MESH_SERVE_USERS = 16384


def free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def rank_cells(args, p, rpb_u, rpb_v):
    """Rank p's cells ``[k, b]`` of a stratum-major layout (cell s is
    rating block (p, (p+s) mod k)), block-local rows: what ``MeshDSGD``
    places on rank p of a k-rank ring."""
    su, si, sv, sw, _, _, icu, icv = args
    return (su[:, p] % rpb_u, si[:, p] % rpb_v, sv[:, p], sw[:, p],
            icu[:, p], icv[:, p])


def check_visit(U, V, ou, ov, cells, plan, p, s, rpb, work, lr, lam, label):
    """Rank p's visit s through ``block_sweep`` over its plan (``[k, 1,
    b]``, any s), from the given whole tables (U block p, V block (p+s)
    mod k, f32 or bf16): twice, bit-equal; against
    ``block_sweep_reference`` on the same slices, max-abs ≤ STRATUM_TOL in
    f32 and within BF16_ULPS in bf16. Returns the difference (max-abs or
    ulps) and the swept slices."""
    k, (ru, rv) = plan.num_blocks, rpb
    q = (p + s) % k
    us, vs = slice(p * ru, (p + 1) * ru), slice(q * rv, (q + 1) * rv)
    runs = []
    for _ in range(2):
        Ub, Vb = U[us].clone(), V[vs].clone()
        cuda_sgd.block_sweep(Ub, Vb, ou[us], ov[vs], plan, s, work, lr=lr,
                             lam=lam)
        runs.append((Ub, Vb))
    Ur, Vr = cuda_sgd.block_sweep_reference(
        U[us], V[vs], *(a[s] for a in cells), ou[us], ov[vs], lr=lr, lam=lam,
        minibatch=plan.minibatch)
    torch.cuda.synchronize()
    (Ub, Vb), again = runs
    if not all(torch.equal(x, y) for x, y in zip((Ub, Vb), again)):
        raise AssertionError(f"{label}: visit ({p}, {s}): two runs differ")
    if U.dtype == torch.bfloat16:
        err = max(float(bf16_ulps(Ub, Ur).max()),
                  float(bf16_ulps(Vb, Vr).max()))
        bar = BF16_ULPS
    else:
        err, bar = max_abs([(Ub, Ur), (Vb, Vr)]), STRATUM_TOL
    finite = bool(torch.isfinite(Ub.float()).all()
                  and torch.isfinite(Vb.float()).all())
    if not (err <= bar and finite):
        raise AssertionError(f"{label}: visit ({p}, {s}) of block_sweep "
                             f"differs from its plain version by {err} "
                             f"(bar {bar}; finite {finite})")
    return err, Ub, Vb


def phase_mesh_visit(U0, V0, args, problem, plan, lr, lam):
    """[mesh.visit]: the per-visit route of the mesh (``block_sweep``) at
    the main path's geometry (ML-25M width, k = 8, rank 128, minibatch
    32,768), each rank p with the plan a k-rank ring builds for it: its
    device-major cells ``[k, 1, b]`` (``dsgd_mesh.visit_plan``). Counted:
    the 8 visits of stratum 0. Checked, f32 and bf16, for every rank p and
    every stratum s of the sweep, each from the same tables: the visit
    twice (bit-equal), against ``block_sweep_reference`` on its slices
    (1e-5 / one bf16 ulp) and against ``stratum_sweep`` of stratum s over
    the whole tables (the same entries in the same order per row:
    bit-equal expected; bf16: the stratum's cast route). The per-visit
    launches of stratum 0 are timed against the stratum's one launch loop
    (CUDA events; interleaved). Returns the launch counts of the counted
    runs by dtype."""
    ou, ov = args[4], args[5]
    k, mb = K, plan.minibatch
    rpb = (problem.users.rows_per_block, problem.items.rows_per_block)
    rank = U0.shape[-1]
    kw = dict(lr=lr, lam=lam)
    cells = [rank_cells(args, p, *rpb) for p in range(k)]
    plans = [dsgd_mesh.visit_plan(c, mb) for c in cells]
    works = [pl.new_work(rank) for pl in plans]

    def visits(U, V, s):
        for p in range(k):
            q = (p + s) % k
            us = slice(p * rpb[0], (p + 1) * rpb[0])
            vs = slice(q * rpb[1], (q + 1) * rpb[1])
            cuda_sgd.block_sweep(U[us], V[vs], ou[us], ov[vs], plans[p], s,
                                 works[p], **kw)

    def stratum_run(U, V, s):
        Us, Vs = U.clone(), V.clone()
        if U.dtype == torch.bfloat16:
            cuda_sgd.stratum_sweep_cast(Us, Vs, torch.empty_like(U0),
                                        torch.empty_like(V0), ou, ov, plan, s,
                                        work, **kw)
        else:
            cuda_sgd.stratum_sweep(Us, Vs, ou, ov, plan, s, work, **kw)
        return Us, Vs

    work = plan.new_work(rank)
    paths, out = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        U, V = U0.to(dtype), V0.to(dtype)
        Uv, Vv = U.clone(), V.clone()
        cuda_sgd.reset_launch_counts()
        visits(Uv, Vv, 0)
        torch.cuda.synchronize()
        got = dict(cuda_sgd.LAUNCHES)
        paths[f"mesh.visit_{name}"] = got
        want = k * plan.n_mb
        if (got["sgd_item_rows_kernel"], got["sgd_user_rows_kernel"],
                got["bf16_to_f32_kernel"], got["f32_to_bf16_kernel"]) != (
                    want, want, 0, 0):
            raise AssertionError(f"mesh.visit launches {got}")
        # every visit of the sweep: the stratum's launch loop (a
        # comparison: its launches are not counted) and the plain version
        ref_err, vs_stratum = 0.0, 0.0
        for s in range(k):
            Us, Vs = stratum_run(U, V, s)
            for p in range(k):
                q = (p + s) % k
                err, Ub, Vb = check_visit(U, V, ou, ov, cells[p], plans[p],
                                          p, s, rpb, works[p], lr, lam,
                                          f"mesh.visit {name}")
                ref_err = max(ref_err, err)
                vs_stratum = max(vs_stratum, max_abs([
                    (Ub.float(), Us[p * rpb[0]:(p + 1) * rpb[0]].float()),
                    (Vb.float(), Vs[q * rpb[1]:(q + 1) * rpb[1]].float())]))
            if s == 0:  # the counted run equals the checked visits
                vs_stratum = max(vs_stratum, max_abs([
                    (Uv.float(), Us.float()), (Vv.float(), Vs.float())]))
        key = "vs_plain_max_ulps" if dtype == torch.bfloat16 else \
            "vs_plain_max_abs"
        out[name] = {key: ref_err, "vs_stratum_max_abs": vs_stratum}
        if vs_stratum != 0.0:
            raise AssertionError(f"mesh.visit {name}: per-visit launches "
                                 f"differ from the stratum's by {vs_stratum}")
    # timing (f32): stratum 0's 8 visits against the stratum's, in turns
    Ut, Vt = U0.clone(), V0.clone()
    stratum = (lambda: cuda_sgd.stratum_sweep(Ut, Vt, ou, ov, plan, 0, work,
                                              **kw))
    visit = (lambda: visits(Ut, Vt, 0))
    st1, vi1, vi2, st2 = (cuda_ms(stratum, 5), cuda_ms(visit, 5),
                          cuda_ms(visit, 5), cuda_ms(stratum, 5))
    host_us = []
    for fn in (stratum, visit):
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        fn()
        host_us.append((time.perf_counter() - h0) * 1e6)
        torch.cuda.synchronize()
    say("mesh.visit", k=k, rank=rank, minibatch=mb, n_mb=plan.n_mb,
        visits_checked=k * k, launches_per_visit_run=2 * k * plan.n_mb,
        launches_per_stratum_run=2 * plan.n_mb,
        **{f"{d}_{key}": v for d, r in out.items() for key, v in r.items()},
        per_visit_ms=min(vi1, vi2), stratum_ms=min(st1, st2),
        per_visit_over_stratum=min(vi1, vi2) / min(st1, st2),
        per_visit_host_us=host_us[1], stratum_host_us=host_us[0])
    return paths


# [mesh.dsgd] at world size 1 is k = 1: the bench's η 0.3 with its 2.5×
# warm boost (tuned at k = 8) diverges there (NaN in the first sweep,
# measured on the card); η 0.1 keeps the schedule and converges
MESH_BENCH = dict(BENCH, learning_rate=0.1)


def mesh_config(dtype) -> dsgd_mesh.MeshDSGDConfig:
    return dsgd_mesh.MeshDSGDConfig(**MESH_BENCH, kernel="cuda",
                                    factor_dtype=dtype)


def phase_mesh_dsgd(dev, part, scratch):
    """[mesh.dsgd]: ``MeshDSGD.fit_device`` at world size 1 (one rank of an
    NCCL group) on the main path's device pipeline (ML-25M width, bench
    settings but η 0.1: ``MESH_BENCH``; 3 sweeps), f32 and bf16, a sharded
    snapshot per sweep; its
    tables bit-equal to ``DSGD.fit_device(num_blocks=1)`` on the card (the
    same launches), its sweeps timed beside that fit's, a resume from the
    second snapshot bit-equal. The fit's own visit (k = 1: one cell, the
    whole tables, 725 steps) is held against the plain version:
    ``block_sweep`` on the fit's layout, plan and initial tables at sweep
    1's η against ``block_sweep_reference`` (``check_visit``: max-abs
    ≤ 1e-5 in f32, one bf16 ulp in bf16, two runs bit-equal). Returns the
    launch counts by dtype and the f32 fits (the mesh model, the
    single-card model) and data."""
    (train, hold, (nu, ni)), gen_s = timed(
        lambda: device_blocking.synthetic_like_device(
            "ml-25m", rank=16, noise=0.1, seed=0, skew_lam=2.0, device=dev))
    u, i, r = train
    holdout = Ratings.from_arrays(*(a.cpu().numpy() for a in hold))
    # the fit's layout, plan and initial tables, as MeshDSGD builds them
    cfg = mesh_config("float32")
    mb = cfg.minibatch_size
    prob = device_blocking.device_block_problem(
        u, i, r, nu, ni, num_blocks=part.num_blocks, minibatch_multiple=mb,
        seed=cfg.seed, minibatch_sort=cfg.minibatch_sort, device=dev)
    rpb = (prob.rows_per_block_u, prob.rows_per_block_v)
    cells = rank_cells((prob.su, prob.si, prob.sv, prob.sw, None, None,
                        prob.icu, prob.icv), 0, *rpb)
    plan = dsgd_mesh.visit_plan(cells, mb)
    U0, V0 = device_blocking.init_factors_device(prob, cfg.num_factors,
                                                 scale=cfg.init_scale)
    lr1 = schedule_from_name(cfg.lr_schedule, cfg.lambda_)(
        cfg.learning_rate, 1)
    paths, keep = {}, None
    for dtype in ("float32", "bfloat16"):
        ckpt = ShardedCheckpointManager(os.path.join(scratch,
                                                     f"mesh_{dtype}"))
        solver = dsgd_mesh.MeshDSGD(mesh_config(dtype), partitioner=part)
        cuda_sgd.reset_launch_counts()
        model, wall = timed(lambda: solver.fit_device(
            u, i, r, nu, ni, checkpoint_manager=ckpt, checkpoint_every=1))
        launches = dict(cuda_sgd.LAUNCHES)
        if not np.array_equal(model.users.ids, prob.to_id_indices()[0].ids):
            raise AssertionError("mesh.dsgd: the fit blocked another layout")
        visit_err, _, _ = check_visit(
            U0.to(model.U.dtype), V0.to(model.U.dtype), prob.omega_u,
            prob.omega_v, cells, plan, 0, 0, rpb,
            plan.new_work(cfg.num_factors), lr1, cfg.lambda_,
            f"mesh.dsgd {dtype}")
        single = DSGD(dataclasses.replace(DSGDConfig(**MESH_BENCH),
                                          factor_dtype=dtype))
        ref, ref_wall = timed(lambda: single.fit_device(
            u, i, r, nu, ni, num_blocks=1, checkpoint_every=1))
        equal = (torch.equal(model.U, ref.U) and torch.equal(model.V, ref.V))
        steps = plan.n_mb * BENCH["iterations"]  # k = 1: one visit a sweep
        rmse = model.rmse(holdout)
        # resume: the newest snapshot never happened
        newest = ckpt.latest_step()
        for name in os.listdir(ckpt.directory):
            if name.startswith(f"ckpt_{newest}."):
                os.unlink(os.path.join(ckpt.directory, name))
        resumed, resume_wall = timed(lambda: dsgd_mesh.MeshDSGD(
            mesh_config(dtype), partitioner=part).fit_device(
                u, i, r, nu, ni, checkpoint_manager=ckpt, checkpoint_every=1,
                resume=True))
        resumed_equal = (torch.equal(resumed.U, model.U)
                         and torch.equal(resumed.V, model.V))
        say(f"mesh.dsgd.{dtype}", world=part.world_size,
            backend=torch.distributed.get_backend(), k=part.num_blocks,
            train=u.shape[0], wall_s=wall, sweep_ms=solver.segment_ms,
            single_sweep_ms=single.segment_ms, single_wall_s=ref_wall,
            ratings_per_s=u.shape[0] * len(solver.segment_ms)
            / (sum(solver.segment_ms) / 1e3), rmse=rmse,
            bit_equal_to_single=equal, launches=launches, n_mb=plan.n_mb,
            **{("visit_vs_plain_max_ulps" if dtype == "bfloat16" else
                "visit_vs_plain_max_abs"): visit_err},
            resumed_from_step=newest - 1, resume_wall_s=resume_wall,
            resumed_bit_equal=resumed_equal, generation_wall_s=gen_s)
        if not equal:
            raise AssertionError(f"mesh.dsgd {dtype}: tables differ from "
                                 "DSGD.fit_device(num_blocks=1)")
        if not resumed_equal:
            raise AssertionError(f"mesh.dsgd {dtype}: resume differs")
        if not math.isfinite(rmse) or len(solver.segment_ms) != 3:
            raise AssertionError(f"mesh.dsgd {dtype}: rmse {rmse}, "
                                 f"{len(solver.segment_ms)} segments")
        if launches != {"sgd_item_rows_kernel": steps,
                        "sgd_user_rows_kernel": steps,
                        "bf16_to_f32_kernel": 0,
                        "f32_to_bf16_kernel": 0}:
            raise AssertionError(f"mesh.dsgd {dtype} launches {launches}")
        paths[f"mesh.dsgd_{dtype}"] = launches
        if dtype == "float32":
            keep = (model, ref, train)
        del resumed
    del prob, cells, plan, U0, V0
    return paths, keep


def phase_mesh_serve(part, model, ref, train):
    """[mesh.serve]: top-K of 16,384 users served over the mesh at world
    size 1 from the fitted mesh model's shards (``ShardedMFModel
    .recommend``: its V shard as the catalog, U gathered), through
    ``MFModel.recommend(mesh=)`` of the single-card model and through
    ``ServingEngine(mesh=)`` (micro-batches of 1,024), against that
    model's plain ``recommend`` (tie-aware; scores within 1e-5)."""
    u = train[0].cpu().numpy()
    users = np.unique(u)[:MESH_SERVE_USERS]
    ref.recommend(users[:SERVE_WARM], k=SERVE_K)
    model.recommend(users[:SERVE_WARM], k=SERVE_K)
    plain, plain_s = timed(lambda: ref.recommend(users, k=SERVE_K))
    sharded, sharded_s = timed(lambda: model.recommend(users, k=SERVE_K))
    ref.recommend(users[:SERVE_WARM], k=SERVE_K, mesh=part)  # catalog
    meshed, mesh_s = timed(lambda: ref.recommend(users, k=SERVE_K,
                                                 mesh=part))
    eng = ServingEngine(ref, k=SERVE_K, mesh=part, max_batch=1024)
    eng.recommend(users[:SERVE_WARM])
    engine, engine_s = timed(lambda: eng.recommend(users))
    out = {}
    for name, (ids, scores) in (("sharded", sharded), ("mesh", meshed),
                                ("engine", engine)):
        diff, compared, wrong = topk_mismatches(ids, scores, *plain)
        out[name] = (diff, compared, wrong)
        if not (diff <= SCORE_TOL and wrong == 0):
            raise AssertionError(f"mesh.serve {name}: score diff {diff}, "
                                 f"{wrong} ids differ")
    say("mesh.serve", users=len(users), k=SERVE_K,
        plain_users_per_s=len(users) / plain_s,
        sharded_users_per_s=len(users) / sharded_s,
        mesh_users_per_s=len(users) / mesh_s,
        engine_users_per_s=len(users) / engine_s,
        **{f"{n}_max_score_diff": v[0] for n, v in out.items()},
        **{f"{n}_ids_compared": v[1] for n, v in out.items()},
        launches=no_dsgd_launches("mesh.serve"))


def phase_mesh_als(dev, part):
    """[mesh.als]: ``MeshALS.fit`` at world size 1 against ``ALS.fit`` on
    the card: 2,000,000 planted ratings at ML-25M width ([als.fit]'s),
    rank 128, 2 rounds, from the same initial tables (both solvers' keyed
    rows): every element within 3e-3·|x| + 3e-4 ([als]'s bar), holdout
    RMSE within 1e-4."""
    (train, hold, _), _ = timed(
        lambda: device_blocking.synthetic_like_device(
            "ml-25m", nnz=int(2_000_000 / 0.95) + 1, rank=16, noise=0.1,
            seed=1, skew_lam=2.0, device=dev))
    data = Ratings.from_arrays(*(a.cpu().numpy() for a in train))
    holdout = Ratings.from_arrays(*(a.cpu().numpy() for a in hold))
    cfg = ALSConfig(num_factors=128, lambda_=ALS_LAMBDA, iterations=2,
                    init_scale=0.1)
    cuda_sgd.reset_launch_counts()
    mesh, mesh_s = timed(lambda: als_mesh.MeshALS(cfg, partitioner=part)
                         .fit(data))
    single, single_s = timed(lambda: ALS(cfg).fit(data))
    err = max_abs([(mesh.U, single.U), (mesh.V, single.V)])
    # [als]'s bar against float64 (tests/test_als.py:382). With 64 MB
    # chunks (the JAX mesh's) against ALS.fit's 256 MB the batched grams
    # and Cholesky solves differed by up to 1.8e-3 (λ 0.01 at rank 128
    # leaves rows with few ratings ill-conditioned); the mesh now cuts
    # ALS.fit's chunks
    close = all(bool(((a - b).abs() <= 3e-3 * b.abs() + 3e-4).all())
                for a, b in ((mesh.U, single.U), (mesh.V, single.V)))
    rm, rs = mesh.rmse(holdout), single.rmse(holdout)
    say("mesh.als", world=part.world_size, rank=128, rounds=2,
        train=data.n, mesh_wall_s=mesh_s, single_wall_s=single_s,
        max_abs_vs_single=err, rmse=rm, rmse_single=rs,
        launches=no_dsgd_launches("mesh.als"))
    if not (close and abs(rm - rs) <= 1e-4 and math.isfinite(rm)):
        raise AssertionError(f"mesh.als: max-abs {err} vs ALS.fit, RMSE "
                             f"{rm} vs {rs}")


def phase_mesh(dev, scratch, visit_args):
    """Phases 24-27 over a world-size-1 NCCL process group in this process
    (no fallback: a failed init raises)."""
    paths = phase_mesh_visit(*visit_args)
    initialize_distributed(DistributedConfig(
        f"tcp://127.0.0.1:{free_port()}", 1, 0))
    try:
        part = Partitioner()
        one = torch.ones(1, device=part.device)
        torch.distributed.all_reduce(one)  # the group answers
        say("mesh", backend=torch.distributed.get_backend(),
            world=part.world_size, grid=tuple(part.grid.shape),
            device=str(part.device), all_reduce_of_one=float(one))
        if float(one) != 1.0:
            raise AssertionError(f"all_reduce over one rank gave {one}")
        dsgd_paths, (model, ref, train) = phase_mesh_dsgd(dev, part, scratch)
        paths.update(dsgd_paths)
        cuda_sgd.reset_launch_counts()
        phase_mesh_serve(part, model, ref, train)
        del model, ref, train
        phase_mesh_als(dev, part)
    finally:
        torch.distributed.destroy_process_group()
    return paths


def launch_counts(paths, name):
    """A kernel's launches over every path's run, and per path."""
    by_path = {path: counts[name] for path, counts in paths.items()}
    return sum(by_path.values()), by_path


def entry(name, err, ms, plain_ms, bound, library_ms, paths, **extra):
    """One kernel's record in the ``{"kernels": [...]}`` line."""
    launches, by_path = launch_counts(paths, name)
    return {"name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches,
            "launches_by_path": by_path, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": library_ms, **extra}


def bound_of(nbytes, flops):
    """(ms, what bounds it): the larger of bytes over HBM and f32
    operations over the f32 peak."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def time_casts(U, V, paths):
    """The two cast kernels at the device path's table sizes, against their
    plain versions (``copy_`` into the preallocated tables) and ``Tensor.to``
    (the library yardstick); bound: n·(2 + 4) B over HBM."""
    n = U.numel() + V.numel()
    Ub, Vb = (torch.empty_like(t, dtype=torch.bfloat16) for t in (U, V))
    Uf, Vf = torch.empty_like(U), torch.empty_like(V)
    bound = bound_of(n * 6, 0)
    down = (lambda: cuda_sgd.f32_to_bf16(U, V, Ub, Vb),
            lambda: (Ub.copy_(U), Vb.copy_(V)),
            lambda: (U.to(torch.bfloat16), V.to(torch.bfloat16)))
    up = (lambda: cuda_sgd.bf16_to_f32(Ub, Vb, Uf, Vf),
          lambda: (Uf.copy_(Ub), Vf.copy_(Vb)),
          lambda: (Ub.to(torch.float32), Vb.to(torch.float32)))
    out = []
    for name, (kern, plain, lib) in (("f32_to_bf16_kernel", down),
                                     ("bf16_to_f32_kernel", up)):
        kern()
        torch.cuda.synchronize()
        if name == "f32_to_bf16_kernel":
            pairs = ((Ub, U.to(torch.bfloat16)), (Vb, V.to(torch.bfloat16)))
        else:
            pairs = ((Uf, Ub.float()), (Vf, Vb.float()))
        err = max_abs([(a.float(), b.float()) for a, b in pairs])
        if not all(torch.equal(a, b) for a, b in pairs):
            raise AssertionError(f"{name} differs from Tensor.to: {err}")
        # interleaved: plain, kernel, kernel, plain
        p1 = cuda_ms(plain, reps=20)
        k1 = cuda_ms(kern, reps=20)
        k2 = cuda_ms(kern, reps=20)
        p2 = cuda_ms(plain, reps=20)
        lib_ms = cuda_ms(lib, reps=20)
        out.append(entry(name, err, min(k1, k2), min(p1, p2), bound, lib_ms,
                         paths))
    say("kernels.casts", elements=n, bytes=n * 6, bound_ms=bound[0],
        **{f"{o['name']}_ms": o["ms"] for o in out},
        **{f"{o['name']}_plain_ms": o["plain_ms"] for o in out},
        **{f"{o['name']}_library_ms": o["library_ms"] for o in out})
    return out


L2_FLUSH_BYTES = 128 * 2 ** 20  # written, then read: evicts the 50 MB L2


def stratum_kernel_ms(U, V, ou, ov, plan, s, work, kw, passes=3):
    """Kernel A's and kernel B's mean device time over every step of
    stratum ``s`` (CUDA events around each launch, the pair alternating as
    on the main path; the tables are updated in place), each the best of
    ``passes`` passes over the stratum."""
    best = (math.inf, math.inf)
    for _ in range(passes):
        marks = [[torch.cuda.Event(enable_timing=True) for _ in range(3)]
                 for _ in range(plan.n_mb)]
        torch.cuda.synchronize()
        for g, (a, b, c) in enumerate(marks):
            t = s * plan.n_mb + g
            a.record()
            cuda_sgd.sgd_item_rows(U, V, ou, ov, plan, t, work, **kw)
            b.record()
            cuda_sgd.sgd_user_rows(U, V, ou, ov, plan, t, work, **kw)
            c.record()
        torch.cuda.synchronize()
        best = (min(best[0], sum(a.elapsed_time(b) for a, b, _ in marks)
                    / plan.n_mb),
                min(best[1], sum(b.elapsed_time(c) for _, b, c in marks)
                    / plan.n_mb))
    return best


def cold_step_ms(U, V, ou, ov, plan, t, work, kw, reps=10):
    """Step ``t`` from a cold L2: before each repetition ``L2_FLUSH_BYTES``
    are written, then read (the read leaves clean lines, so the timed
    kernels pay no write-back of the flush). Returns the medians of kernel
    A and of kernel B (B right after A, as on the main path)."""
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=U.device)
    a_ms, b_ms = [], []
    for _ in range(reps):
        flush.fill_(1.0)
        flush.sum()
        a, b, c = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        a.record()
        cuda_sgd.sgd_item_rows(U, V, ou, ov, plan, t, work, **kw)
        b.record()
        cuda_sgd.sgd_user_rows(U, V, ou, ov, plan, t, work, **kw)
        c.record()
        c.synchronize()
        a_ms.append(a.elapsed_time(b))
        b_ms.append(b.elapsed_time(c))
    return statistics.median(a_ms), statistics.median(b_ms)


def time_kernels(U0, V0, args, plan, plan_s, lam, paths):
    """Kernel A and kernel B against their plain versions on step 0 of the
    main path (stratum 0, minibatch 0: k visits × mb entries), each with
    its share of the step's bound from this data; each kernel's mean over
    every step of stratum 0 and step 0 from a cold L2 (``cold_step_ms``);
    the kernels' registers, shared memory and resident blocks; then
    stratum 0's launch loop on the host clock beside its device time."""
    su, si, sv, sw, ou, ov, icu, icv = args
    k, mb, t = plan.num_blocks, plan.minibatch, 0
    rank = U0.shape[-1]
    lr = schedule_from_name("warm_boost", lam)(0.3, 1)
    kw = dict(lr=lr, lam=lam)
    wk, wp = plan.new_work(rank), plan.new_work(rank)
    n_e = plan.entry_base[t + 1] - plan.entry_base[t]  # real entries
    n_v, n_u = plan.v_segments[t], plan.u_segments[t]  # distinct rows
    touched = cuda_sgd.plan_rows(plan.v_prow[plan.entry_base[t]:
                                             plan.entry_base[t + 1]])

    # each kernel against its plain version from the same inputs (kernel B
    # from the plain kernel A's e and snapshot)
    Uk, Vk, Up, Vp = U0.clone(), V0.clone(), U0.clone(), V0.clone()
    cuda_sgd.sgd_item_rows(Uk, Vk, ou, ov, plan, t, wk, **kw)
    cuda_sgd.sgd_item_rows_reference(Up, Vp, ov, plan, t, wp, **kw)
    cuda_sgd.sgd_user_rows(Uk, Vk, ou, ov, plan, t, wp, **kw)
    cuda_sgd.sgd_user_rows_reference(Up, ou, plan, t, wp, **kw)
    torch.cuda.synchronize()
    a_err = max_abs([(Vk, Vp), (wk[0][:n_e], wp[0][:n_e]),
                     (wk[1][touched], wp[1][touched])])
    b_err = max_abs([(Uk, Up)])
    a_ms = cuda_ms(lambda: cuda_sgd.sgd_item_rows(
        Uk, Vk, ou, ov, plan, t, wk, **kw), reps=20)
    b_ms = cuda_ms(lambda: cuda_sgd.sgd_user_rows(
        Uk, Vk, ou, ov, plan, t, wk, **kw), reps=20)
    a_plain_ms = cuda_ms(lambda: cuda_sgd.sgd_item_rows_reference(
        Up, Vp, ov, plan, t, wp, **kw), reps=5)
    b_plain_ms = cuda_ms(lambda: cuda_sgd.sgd_user_rows_reference(
        Up, ou, plan, t, wp, **kw), reps=5)
    # the library yardstick of kernel B: one index_add_ per table of the
    # step's deltas (padding rows add exact zeros)
    ur = su[0][:, :mb].reshape(-1).long()
    ir = si[0][:, :mb].reshape(-1).long()
    rule = RegularizedSGDUpdater(learning_rate=lr, lambda_=lam,
                                 schedule=schedule_from_name("constant"))
    du, dv = rule.delta(sv[0][:, :mb].reshape(-1), U0[ur], V0[ir],
                        weights=sw[0][:, :mb].reshape(-1), omega_u=ou[ur],
                        omega_v=ov[ir])
    lib_ms = cuda_ms(lambda: (Up.index_add_(0, ur, du),
                              Vp.index_add_(0, ir, dv)), reps=20)

    # beyond the warm step 0 (its rows left in the L2 by the repetition
    # before): every step of stratum 0, and step 0 from a cold L2
    Uw, Vw = U0.clone(), V0.clone()
    a_stratum_ms, b_stratum_ms = stratum_kernel_ms(Uw, Vw, ou, ov, plan, 0,
                                                   wk, kw)
    Uw, Vw = U0.clone(), V0.clone()
    a_cold_ms, b_cold_ms = cold_step_ms(Uw, Vw, ou, ov, plan, 0, wk, kw)
    del Uw, Vw
    attrs = cuda_sgd.step_kernel_attrs(rank)

    # the launch loop of stratum 0: host time to enqueue its n_mb steps
    # beside the device time they take (best of 5)
    host_us, dev_ms = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        a, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        h0 = time.perf_counter()
        cuda_sgd.stratum_sweep(Uk, Vk, ou, ov, plan, 0, wk, **kw)
        h1 = time.perf_counter()
        e.record()
        e.synchronize()
        host_us.append((h1 - h0) / plan.n_mb * 1e6)
        dev_ms.append(a.elapsed_time(e) / plan.n_mb)

    # bounds from this step's data. The ported function is the whole step
    # (both kernels): it reads each distinct row once with its ω and 24 B of
    # streams per entry, and writes each distinct row back once. Kernel A's
    # share is both sides' reads, the streams and V's writes; kernel B's is
    # U's writes; their sum is the step's bound.
    row = rank * 4
    n_all = k * mb
    a_bytes = (n_u + n_v) * (row + 4) + n_all * 24 + n_v * row
    b_bytes = n_u * row
    a_flops, b_flops = n_e * 7 * rank, n_e * 5 * rank
    step_bms, _ = bound_of(a_bytes + b_bytes, a_flops + b_flops)
    step_ms = a_ms + b_ms
    # the same bound for each step of stratum 0 (its own rows), averaged
    stratum_bms = sum(bound_of(
        (plan.u_segments[g] + plan.v_segments[g]) * (2 * row + 4)
        + n_all * 24,
        (plan.entry_base[g + 1] - plan.entry_base[g]) * 12 * rank)[0]
        for g in range(plan.n_mb)) / plan.n_mb
    # what the design moves beyond the function (not in the bound): the
    # per-entry row gathers (A's U rows: the re-reads within a visit; B's
    # snapshot rows) through the L2, the old rows B reads again after A
    # gathered them, the snapshot, e, and the plan's positions
    design = dict(gathered_user_rows=n_e * row,
                  user_rows_read_again_in_b=n_u * row,
                  snapshot_writes=n_v * row, snapshot_gathers=n_e * row,
                  e_buffer=2 * n_e * 4, plan=2 * n_e * 20)
    out = []
    for name, err, ms, pms, bound, lib, side in (
            ("sgd_item_rows_kernel", a_err, a_ms, a_plain_ms,
             bound_of(a_bytes, a_flops), None, "a"),
            ("sgd_user_rows_kernel", b_err, b_ms, b_plain_ms,
             bound_of(b_bytes, b_flops), lib_ms, "b")):
        if not err <= STRATUM_TOL:
            raise AssertionError(f"{name} max-abs {err:.3e} vs plain")
        out.append(entry(
            name, err, ms, pms, bound, lib, paths, step_ms=step_ms,
            step_bound_ms=step_bms, per_visit_replaces=f"{_PALLAS}:172",
            stratum_ms=a_stratum_ms if side == "a" else b_stratum_ms,
            cold_l2_ms=a_cold_ms if side == "a" else b_cold_ms,
            **{k[2:]: v for k, v in attrs.items() if k[0] == side}))
    say("kernels.timing", visits=k, minibatch=mb, real_entries=n_e,
        distinct_u=n_u, distinct_v=n_v, plan_build_s=plan_s,
        plan_bytes=plan.nbytes(), longest_segment_u_step0=plan.longest_u[t],
        longest_segment_v_step0=plan.longest_v[t],
        longest_segment_u=max(plan.longest_u),
        longest_segment_v=max(plan.longest_v), chunk=plan.chunk,
        kernel_a_ms=a_ms, kernel_b_ms=b_ms, step_ms=step_ms,
        step_bound_ms=step_bms, step_share_of_bound=step_bms / step_ms,
        stratum0_kernel_a_ms=a_stratum_ms, stratum0_kernel_b_ms=b_stratum_ms,
        stratum0_step_ms=a_stratum_ms + b_stratum_ms,
        stratum0_step_bound_ms=stratum_bms,
        stratum0_share_of_bound=stratum_bms / (a_stratum_ms + b_stratum_ms),
        cold_l2_kernel_a_ms=a_cold_ms, cold_l2_kernel_b_ms=b_cold_ms,
        cold_l2_step_ms=a_cold_ms + b_cold_ms, l2_flush_bytes=L2_FLUSH_BYTES,
        **{f"kernel_{k}": v for k, v in attrs.items()},
        function_bytes=a_bytes + b_bytes,
        design_bytes_beyond=sum(design.values()), **design,
        old_pair_scratch_bytes=2 * 2 * n_all * row,
        stratum0_device_ms_per_step=min(dev_ms),
        stratum0_host_us_per_step=min(host_us),
        host_is_pace=min(host_us) / 1e3 >= min(dev_ms))
    return out


if __name__ == "__main__":
    sys.exit(main())
