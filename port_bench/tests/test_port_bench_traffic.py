"""The one traffic generator: the same pool for a seed, the same sizes for
every seed, the mixes' length bands, batches sorted and padded as the
program's loaders pad them."""
import json

import numpy as np
import pytest
import torch

from port_bench import cell as C, traffic

CPU = torch.device("cpu")


def pool(mix, seed):
    return traffic.make_pool(mix, seed, C.tokenizer(), CPU)


@pytest.mark.parametrize("name", sorted(
    p.stem for p in (C.HERE / "traffic").glob("*.json")))
def test_sizes_in_band(name):
    mix = json.loads((C.HERE / "traffic" / f"{name}.json").read_text())
    sz = traffic.sizes(mix)
    assert len(sz["chars"]) == mix["batch"] * mix["pool"]
    if "audio_s" in mix:
        s = sz["samples"] / traffic.SR
        lo, hi = mix["audio_s"][0][1], mix["audio_s"][-1][1]
        assert lo <= s.min() and s.max() <= hi
        assert np.all(np.diff(s) >= 0)
        cps = sz["chars"] / s
        spread = mix["chars_spread"]
        assert cps.min() >= mix["chars_per_s"] * (1 - spread) - 1 / lo
        assert cps.max() <= mix["chars_per_s"] * (1 + spread) + 1 / lo
    else:
        c = sz["chars"]
        assert mix["chars"][0][1] <= c.min() and c.max() <= mix["chars"][-1][1]
        bulk = np.mean((c >= 150) & (c <= 265))
        assert bulk >= 0.75


def test_same_seed_same_pool_and_other_seeds_same_shapes(tiny_cell):
    mix = {"driver": "decode", "batch": 3, "pool": 2,
           "audio_s": [[0.0, 0.5], [1.0, 1.0]], "chars_per_s": 15.5,
           "chars_spread": 0.15, "amplitude": 0.1}
    a, b, c = pool(mix, 7), pool(mix, 7), pool(mix, 2 ** 31 + 11)
    for x, y, z in zip(a, b, c):
        for k in ("wave", "wave_len", "text", "text_len"):
            assert np.array_equal(x[k], y[k])
            assert x[k].shape == z[k].shape
        assert np.array_equal(x["wave_len"], z["wave_len"])
        assert np.array_equal(x["text_len"], z["text_len"])
        assert not np.array_equal(x["wave"], z["wave"])
        assert x["wave"].dtype == np.int16


def test_batches_sorted_and_padded():
    mix = {"driver": "decode", "batch": 4, "pool": 3,
           "audio_s": [[0.0, 0.5], [1.0, 2.0]], "chars_per_s": 15.5,
           "chars_spread": 0.15, "amplitude": 0.1}
    p = pool(mix, 3)
    for prev, nxt in zip(p, p[1:]):
        assert prev["wave_len"].max() <= nxt["wave_len"].min()
    for b in p:
        assert (b["wave"].shape[1] // 160 + 1) % 64 == 0
        assert b["text"].shape[1] % 16 == 0
    lm = pool({"driver": "lm_train", "batch": 4, "pool": 3,
               "chars": [[0.0, 5], [1.0, 40]]}, 3)
    for prev, nxt in zip(lm, lm[1:]):
        assert prev["text_len"].max() <= nxt["text_len"].min()
    assert all(b["text"].shape[1] % 16 == 0 for b in lm)


def test_cycle_is_a_seeded_order_repeated():
    it = traffic.cycle(5, 9)
    first = [next(it) for _ in range(10)]
    assert sorted(first[:5]) == list(range(5)) and first[:5] == first[5:]
    it2 = traffic.cycle(5, 9)
    assert [next(it2) for _ in range(5)] == first[:5]
