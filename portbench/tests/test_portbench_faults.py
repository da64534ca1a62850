"""The check catches what it is there to catch: whole runs of every cell at
a tiny size on the CPU (the look for a card skipped), once sound and once
with each fault the cell can have planted in the timed path underneath,
and once as the cell's control (the nearest precision below the
configuration's). The sound run comes out correct; every other one does
not. The exchange between chips is not among the faults: every cell runs
on one card; a serving cell holds no state that could stay unchanged."""

import io

import pytest

from portbench import faults, harness
from portbench.tests.tiny import TINY, control

SEED = 3_000_000_019  # past 32 signed bits, as a check's seeds can be


def _run(cell, **kw):
    return harness.run_cell(cell, SEED, 0.3, False, device="cpu",
                            log=io.StringIO(), **{**TINY[cell], **kw})


@pytest.mark.parametrize("cell", sorted(TINY))
def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["compared"]
    assert list(res)[-1] == "compared"


@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_is_not_correct(cell):
    res = _run(cell, **control(cell))
    assert not res["correct"], res["compared"]


# -- the faults -------------------------------------------------------------


def _cell_faults():
    for cell in sorted(TINY):
        for fault in faults.FAULTS_OF[harness.resolve(cell).mix["solver"]]:
            yield cell, fault


@pytest.mark.parametrize("cell,fault", list(_cell_faults()))
def test_fault_is_caught(monkeypatch, cell, fault):
    faults.plant(monkeypatch, harness.resolve(cell).mix["solver"], fault)
    res = _run(cell)
    assert not res["correct"], res["compared"]


def test_stream_pass_after_pass_is_correct():
    """A window longer than the stream starts it again on a fresh model;
    the check replays the last pass from the keyed init."""
    cell = "netflix_r128.online_stream"
    res = harness.run_cell(cell, SEED, 1.0, False, device="cpu",
                           log=io.StringIO(), **TINY[cell])
    n_batches = TINY[cell]["config_override"]["data"]["ratings"] // 1000
    assert res["attempted"] > 2 * n_batches
    assert res["correct"], res["compared"]
