"""The check decides ``correct``: a sound run of each cell passes, and
with the timed path broken underneath (each fault the cell can have) or
the control in the program's place it reads false. Tiny cells on the CPU;
the limits here are set for that size as the cells' own are for theirs."""
import pytest

from port_bench import run

LIMITS = {
    "las_decode": {"score_gap": 1e-4, "nbest_gap": 1e-4},
    "lm_train": {"loss_gap": 1e-5, "grad_gap": 1e-5, "delta_gap": 1e-3},
}
FAULTS = [("las_decode", "half_batch"), ("las_decode", "alter_token"),
          ("las_decode", "frozen"),
          ("lm_train", "frozen"), ("lm_train", "half_batch")]


@pytest.mark.parametrize("workload", sorted(LIMITS))
def test_sound_run_is_correct(tiny_cell, workload):
    cell = tiny_cell(workload, limits=LIMITS[workload])
    r = run.run_cell(cell, 0.5, False)
    assert r["correct"], r["compared"]
    assert list(r)[-1] == "compared" and r["attempted"] >= 1
    assert set(r["compared"]) == set(LIMITS[workload])


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_fault_is_caught(tiny_cell, workload, fault):
    cell = tiny_cell(workload, limits=LIMITS[workload])
    r = run.run_cell(cell, 0.5, False, fault=fault)
    assert not r["correct"], r["compared"]


def test_fp8_control_fails(tiny_cell):
    cell = tiny_cell("las_decode", limits=LIMITS["las_decode"])
    drv, _ = run.measure(cell, 0.5, False)
    drv.close()
    got = drv.readings("fp8")
    assert any(got[k] > lim for k, lim in LIMITS["las_decode"].items()), got


def test_nbest_gap_alone_catches_an_altered_answer(tiny_cell):
    """One token of each best hypothesis altered, read by ``nbest_gap``
    alone (the served list's scores against each other), over several
    seeds."""
    for seed in (3, 2 ** 31 + 5, 4_100_000_123):
        cell = tiny_cell("las_decode", seed=seed, limits=LIMITS["las_decode"])
        r = run.run_cell(cell, 0.5, False, fault="alter_token")
        gap = r["compared"]["nbest_gap"]
        assert gap["value"] > gap["limit"], (seed, r["compared"])


@pytest.mark.card
def test_tf32_control_fails_on_the_card(card, tiny_cell):
    """TF32 exists only on the card: the LM cell's control there."""
    cell = tiny_cell("lm_train", limits=LIMITS["lm_train"])
    cell.device = card
    drv, _ = run.measure(cell, 0.5, False)
    drv.close()
    got = drv.readings("tf32")
    assert any(got[k] > lim for k, lim in LIMITS["lm_train"].items()), got


def test_traced_run_reads_ranges_and_breakdown(tiny_cell):
    cell = tiny_cell("lm_train", limits=LIMITS["lm_train"])
    r = run.run_cell(cell, 0.5, True)
    assert r["correct"]
    assert r["metrics"]["data_wait_ms.lm_train"]["value"] >= 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert r["device"]["window_s"] > 0
