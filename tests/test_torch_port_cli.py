"""The port's command line (``main.py``, and ``train.py`` as its alias)
against the JAX package's ``main.py``, and the fbank front end's kernel
gate (``audio.use_pallas``) against the JAX package's."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import main as jax_main
from end_to_end_asr_pytorch_tpu.ops.audio import AudioFrontend as JaxFrontend
from end_to_end_asr_pytorch_tpu_torch import main as port_main
from end_to_end_asr_pytorch_tpu_torch import train as port_train
from end_to_end_asr_pytorch_tpu_torch.ops import audio as port_audio
from end_to_end_asr_pytorch_tpu_torch.ops import cuda as cuda_kernels
from tests.torch_port_fixtures import OnCard

REFERENCE_ARGV = ["--config", "config/libri/asr_example.yaml", "--name", "x",
                  "--logdir", "l/", "--ckpdir", "c/", "--outdir", "o/",
                  "--load", "m.pth", "--seed", "3", "--cudnn-ctc", "--njobs",
                  "2", "--no-pin", "--test", "--no-msg"]


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("build", [port_main.build_parser,
                                   port_train.build_parser])
def test_parser_takes_the_reference_command_line(build):
    """Every flag of the JAX package's main.py with its default, the
    compatibility flags included; the same reference command line parses
    to the same values."""
    assert _options(build()) == _options(jax_main.build_parser())
    got = vars(build().parse_args(REFERENCE_ARGV))
    assert got == vars(jax_main.build_parser().parse_args(REFERENCE_ARGV))
    assert got["cudnn_ctc"] and got["no_pin"] and got["test"]


def test_main_dispatch_and_unported_modes(tmp_path, monkeypatch):
    cfg = tmp_path / "c.yaml"
    cfg.write_text(yaml.safe_dump({
        "data": {"corpus": {"name": "none"}, "audio": {"feat_dim": 40},
                 "text": {"mode": "character"}},
        "model": {}, "hparas": {}}))
    # --amp and --lm (which raised until amp and LM training were ported)
    # are taken by every mode: each goes on to the device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--test"], ["--amp"], ["--test", "--amp"], ["--lm"],
                  ["--lm", "--amp", "--cudnn-ctc", "--no-pin"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_main.main(["--config", str(cfg), "--no-msg",
                            "--logdir", str(tmp_path / "l"), "--ckpdir",
                            str(tmp_path / "c"), "--outdir",
                            str(tmp_path / "o"), *extra])


@pytest.mark.parametrize("case,route", [
    ("default", "fused"), ("use_pallas_false", "plain"),
    ("8khz", "plain"), ("8khz_forced", "fused"), ("cpu_wave", "plain"),
    ("kernels_off", "plain")])
def test_fbank_takes_k1_by_the_jax_gate(monkeypatch, case, route):
    routes = []

    def rec(name):
        def run(wave, cosw, msinw, mel_fb, n_fft, hop, log_eps):
            routes.append(name)
            T = wave.shape[1] // hop + 1
            return torch.zeros(wave.shape[0], T, mel_fb.shape[1])
        return run

    monkeypatch.setattr(port_audio, "fbank_fused", rec("fused"))
    monkeypatch.setattr(port_audio, "fbank_plain", rec("plain"))
    monkeypatch.setattr(cuda_kernels, "USE_KERNELS", case != "kernels_off")
    cfg = {"feat_type": "fbank", "feat_dim": 40}
    if case == "use_pallas_false":
        cfg["use_pallas"] = False
    if case.startswith("8khz"):
        cfg["sample_rate"] = 8000
    if case == "8khz_forced":
        cfg["use_pallas"] = True
    fe = port_audio.AudioFrontend(cfg, device="cpu")
    wave = torch.from_numpy(np.random.RandomState(0).randn(2, 4000)
                            .astype(np.float32))
    if case != "cpu_wave":
        wave = wave.as_subclass(OnCard)
    fe(wave, torch.tensor([4000, 3000]))
    assert routes == [route]
    # the JAX package's own gate for the same config (its "non-CPU backend"
    # is the card wave here)
    jax_use = JaxFrontend(cfg).use_pallas or (
        cfg.get("use_pallas", "auto") == "auto" and fe.n_fft % 80 == 0
        and fe.hop % 80 == 0)
    if case not in ("cpu_wave", "kernels_off"):
        assert jax_use == (route == "fused")
