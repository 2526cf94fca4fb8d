"""Fixtures of the benchmark's CPU tests: cells of the benchmark's own
configurations and mixes cut to a size a CPU test holds (widths too: these
test the harness and the check, not the program's speed), and the marker
of the tests that need the card, which skip here."""
import copy

import pytest
import torch

from port_bench import cell as C

TINY_MIX = {
    "decode": {"driver": "decode", "batch": 4, "pool": 2,
               "audio_s": [[0.0, 0.3], [1.0, 0.5]], "chars_per_s": 15.5,
               "chars_spread": 0.0, "amplitude": 0.1},
    "lm_train": {"driver": "lm_train", "batch": 4, "pool": 3,
                 "chars": [[0.0, 5], [1.0, 30]]},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped "
                            "without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def tiny_configs():
    cfgs = C.configs_by_name(C.load_spec())
    las, lm = copy.deepcopy(cfgs["libri_las"]), copy.deepcopy(cfgs["libri_lm"])
    enc = las["model"]["encoder"]
    enc.update(dim=[16, 16], dropout=[0.2, 0.2], layer_norm=[False] * 2,
               proj=[False] * 2, sample_rate=[1] * 2)
    las["model"]["attention"].update(dim=8, loc_kernel_size=5,
                                     loc_kernel_num=2)
    las["model"]["decoder"]["dim"] = 16
    las["decode"]["beam_size"] = 4
    lm["model"].update(emb_dim=16, dim=16)
    return {"libri_las": las, "libri_lm": lm}


@pytest.fixture
def tiny_cell():
    """tiny_cell(workload, seed, limits) on the CPU."""
    made = []

    def make(workload, seed=12345678901, limits=None):
        spec = C.load_spec()
        w = {x["name"]: x for x in spec["workloads"]}[workload]
        mix = C._json(C.HERE / "traffic" / f"{w['traffic']}.json")
        c = C.Cell(workload, seed, torch.device("cpu"), spec=spec,
                   configs=tiny_configs(), mix=TINY_MIX[mix["driver"]],
                   limits=limits or {})
        made.append(c)
        return c

    yield make
    for c in made:
        C.remove_tree(c.tmp)
