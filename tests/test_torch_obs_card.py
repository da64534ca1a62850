"""The port's observability planes on the card. These tests need a CUDA
device and skip without one; on the machine with the card run

    python -m pytest --noconftest -q tests/test_torch_obs_card.py

(``--noconftest``: the suite's conftest imports the JAX package). They pin
what the CPU cannot show: a span waits on the stream that produced its
output and on no other; the sync-debug guard counts (``log``) or raises
(``disallow``) on an ``.item()``; the device-memory sample is supported;
a profiler capture names the step kernels.
"""

import json
import os
import threading
import time

import pytest
import torch

from large_scale_recommendation_tpu_torch.core.generators import (
    SyntheticMFGenerator,
)
from large_scale_recommendation_tpu_torch.models.dsgd import DSGD, DSGDConfig
from large_scale_recommendation_tpu_torch.obs import introspect
from large_scale_recommendation_tpu_torch.obs.registry import MetricsRegistry
from large_scale_recommendation_tpu_torch.obs.trace import Tracer
from large_scale_recommendation_tpu_torch.obs.transfers import TransferLedger

pytestmark = pytest.mark.cuda

SLEEP_CYCLES = 1_000_000_000  # ~0.5 s of torch.cuda._sleep on an H100


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the obs planes' card paths)")
    return torch.device("cuda")


def test_span_waits_on_the_producing_stream_only(card):
    """A long kernel on a second stream stays out of a span whose output
    comes from the current stream; the same kernel on the current stream
    is inside it."""
    tracer = Tracer()
    x = torch.ones(1024, device=card)
    # load every kernel first: a module's first (lazy) load waits for the
    # kernels running on the card, whatever their stream
    (x * 2, x + 1)
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    side = torch.cuda.Stream(card)
    with torch.cuda.stream(side):
        torch.cuda._sleep(SLEEP_CYCLES)
    with tracer.span("short") as sp:
        sp.out = {"y": [x * 2]}
    short = tracer.events()[-1]["dur"] / 1e6
    side_busy = not side.query()
    torch.cuda.synchronize()
    with tracer.span("long") as sp:
        torch.cuda._sleep(SLEEP_CYCLES)
        sp.out = x + 1
    long = tracer.events()[-1]["dur"] / 1e6
    assert side_busy, "the side stream's kernel ended before the span"
    assert short < 0.1, short
    assert long > 0.2, long


def test_sync_debug_guard_counts_and_raises(card):
    x = torch.ones(8, device=card)
    reg = MetricsRegistry()
    log = TransferLedger(guard_mode="log", registry=reg)
    with log.guard("probe"):
        assert x.sum().item() == 8.0
    assert torch.cuda.get_sync_debug_mode() == 0
    assert log.snapshot()["implicit_by_site"] == {"probe": 1}
    assert reg.counter("implicit_transfers_total", site="probe").value == 1
    strict = TransferLedger(guard_mode="disallow", registry=reg)
    with pytest.raises(RuntimeError, match="synchronizing"):
        with strict.guard("strict"):
            x.sum().item()
    assert torch.cuda.get_sync_debug_mode() == 0
    assert strict.implicit_total == 1
    with strict.guard("strict"), strict.allow("strict"):
        assert x.sum().item() == 8.0  # a deliberate crossing
    assert strict.implicit_total == 1


def test_device_memory_sample_is_supported(card):
    keep = torch.empty(1 << 20, dtype=torch.float32, device=card)
    sample = introspect.Introspector(
        registry=MetricsRegistry()).sample_device_memory()
    assert sample["supported"]
    stats = sample["devices"][0]["stats"]
    assert stats["bytes_in_use"] >= keep.nbytes
    assert stats["bytes_limit"] >= stats["bytes_in_use"]
    assert sample["live_arrays"]["bytes"] >= keep.nbytes
    assert introspect.device_peaks()["hbm_gbs"] > 0


def test_capture_profile_names_the_step_kernel(card, tmp_path):
    """A capture taken while another thread trains holds the step pair's
    kernel."""
    ratings = SyntheticMFGenerator(num_users=800, num_items=600, rank=8,
                                   seed=0).generate(20_000)
    cfg = DSGDConfig(num_factors=32, iterations=2, learning_rate=0.05,
                     lambda_=0.05, minibatch_size=1024, init_scale=0.1)
    DSGD(cfg).fit(ratings, num_blocks=2)  # builds and loads the library
    stop = threading.Event()

    def train():
        while not stop.is_set():
            DSGD(cfg).fit(ratings, num_blocks=2)

    worker = threading.Thread(target=train)
    worker.start()
    try:
        time.sleep(0.2)
        out = introspect.capture_profile(str(tmp_path), seconds=0.5)
    finally:
        stop.set()
        worker.join(timeout=120)
    assert not worker.is_alive()
    assert introspect.TRACE_FILE in out["files"]
    with open(os.path.join(tmp_path, introspect.TRACE_FILE)) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any("sgd_item_rows_kernel" in n for n in names)
