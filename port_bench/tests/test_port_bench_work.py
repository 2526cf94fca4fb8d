"""The work counters against hand counts at tiny shapes."""
import pytest

from port_bench import work

MODEL = {"encoder": {"dim": [2], "module": "LSTM"},
         "attention": {"dim": 3, "loc_kernel_size": 4, "loc_kernel_num": 2},
         "decoder": {"dim": 2, "module": "LSTM"}}


def test_rnn_step_and_frames():
    assert work.rnn_step("LSTM", 3, 2) == 2 * (3 + 2) * 8
    assert work.rnn_step("GRU", 3, 2) == 2 * (3 + 2) * 6
    with pytest.raises(NotImplementedError):
        work.rnn_step("RNN_TANH", 3, 2)
    assert work.frames(160 * 9) == 10 and work.frames(159) == 1


def test_least_s_is_the_larger_bound():
    assert work.least_s(989e12, 0) == pytest.approx(1.0)
    assert work.least_s(0, 3.35e12) == pytest.approx(1.0)
    assert work.least_s(989e12, 6.7e12) == pytest.approx(2.0)


def test_fbank_work():
    f, b = work.fbank_work(2, 160 * 9, n_mels=40)
    assert f == 2 * 10 * (2 * 2 * 400 * 201 + 3 * 201 + 2 * 201 * 40)
    assert b == 4 * 2 * (160 * 9 + 10 * 40)


def test_scan_work():
    assert work.scan_work(5, 2, 4, "LSTM") == (5 * 2 * 2 * 8,
                                               5 * 10 * 4 + 4 * 2 * 8)
    assert work.scan_work(5, 2, 4, "gru") == (5 * 2 * 2 * 6,
                                              5 * 8 * 4 + 4 * 2 * 6)


def test_scan_calls():
    n = 160 * 15                      # 16 frames, 4 encoder frames
    assert work.encoder_scans(MODEL, [n, n], 2) == [(8, 2, 2, "LSTM")] * 2
    lm = {"dim": 3, "layer": 2, "module": "GRU"}
    assert work.lm_scans(lm, [4, 6], 4, 2) == [(10, 3, 4, "GRU")] * 4


def test_encoder_flops():
    t = 8
    conv = (2 * 9 * 1 * 64 * 8 * 40 + 2 * 9 * 64 * 64 * 8 * 40
            + 2 * 9 * 64 * 128 * 4 * 20 + 2 * 9 * 128 * 128 * 4 * 20)
    lstm = 2 * 2 * (2 * (1280 + 2) * 8)          # 2 frames, 2 directions
    ctc = 2 * 2 * 4 * 3
    assert work.encoder_flops(MODEL, 40, 3, t) == conv + lstm + ctc


def test_step_counts():
    assert work.att_step(MODEL, 5, 4) == 2 * 2 * 3 + 5 * (2 * 4 * 2 + 2 * 2 * 3
                                                        + 2 * 3 + 2 * 3)
    assert work.speller_step(MODEL, 3) == 2 * (2 + 3 + 2) * 8 + 2 * 2 * 3
    lm = {"emb_dim": 2, "dim": 2, "layer": 2, "module": "LSTM"}
    assert work.lm_step(lm, 3) == 2 * (2 * 4 * 8) + 2 * 2 * 3
    assert work.lm_step(dict(lm, module="GRU"), 3) == 2 * (2 * 4 * 6) + 2 * 2 * 3
    cfg = {"model": lm, "vocab": 3}
    assert work.lm_train_flops(cfg, [4, 6]) == 3 * 10 * work.lm_step(lm, 3)


def test_decode_flops():
    cfg = {"model": MODEL, "vocab": 3, "feat_dim": 40}
    lm = {"model": {"emb_dim": 2, "dim": 2, "layer": 1, "module": "LSTM"}}
    n = 160 * 15                      # 16 frames, 4 encoder frames
    enc = work.encoder_flops(MODEL, 40, 3, 16) + 2 * 2 * 4 * 4 * 3
    step = (work.att_step(MODEL, 4, 4) + work.speller_step(MODEL, 3)
            + work.lm_step(lm["model"], 3) + 2 * 4 * 3)
    assert work.decode_flops(cfg, lm, [n], 2, 5) == enc + 5 * 2 * step
