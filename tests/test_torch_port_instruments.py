"""The port's experiment instruments against the JAX package on the CPU:
``utils/util.py`` (``human_format``, ``Timer``, ``feat_to_fig``), the
progress line, the TensorBoard event writer (``utils/tensorboard.py``,
``utils/png.py``) against tensorboardX and read back with tensorboard's
``EventAccumulator``, validation's alignment figures, ``utils/profiler.py``
and the corpus CLI (``data/make_synthetic.py``).

Inputs come from ``np.random.RandomState``. Every comparison is exact:
strings, bytes, float32 scalars and uint8 pixels."""
import ast
import hashlib
import io
import math
import struct
import sys
import time
import types
from pathlib import Path

import jax  # noqa: F401  (JAX on the CPU, as every parity test)
import matplotlib
import numpy as np
import pytest
import torch
import yaml

matplotlib.use("Agg")
from matplotlib import cm  # noqa: E402
from matplotlib.colors import Normalize  # noqa: E402
from PIL import Image  # noqa: E402
from tensorboard.backend.event_processing.event_accumulator import (  # noqa: E402
    EventAccumulator)
from tensorboardX.crc32c import crc32c as tbx_crc32c  # noqa: E402
from tensorboardX.proto.event_pb2 import Event  # noqa: E402
from tensorboardX.record_writer import masked_crc32c as tbx_masked  # noqa: E402
from tensorboardX.summary import scalar as tbx_scalar  # noqa: E402
from tensorboardX.summary import text as tbx_text  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from end_to_end_asr_pytorch_tpu.data import make_synthetic as jax_cli  # noqa: E402
from end_to_end_asr_pytorch_tpu.solvers.base import BaseSolver as JaxBase  # noqa: E402
from end_to_end_asr_pytorch_tpu.utils import util as jax_util  # noqa: E402
from end_to_end_asr_pytorch_tpu_torch import train  # noqa: E402
from end_to_end_asr_pytorch_tpu_torch.data import make_synthetic  # noqa: E402
from end_to_end_asr_pytorch_tpu_torch.solvers.base import BaseSolver  # noqa: E402
from end_to_end_asr_pytorch_tpu_torch.utils import profiler  # noqa: E402
from end_to_end_asr_pytorch_tpu_torch.utils import tensorboard as tb  # noqa: E402
from end_to_end_asr_pytorch_tpu_torch.utils.png import encode_png, png_size  # noqa: E402
from end_to_end_asr_pytorch_tpu_torch.utils.util import (  # noqa: E402
    feat_to_fig, human_format)

torch.set_num_threads(1)


def _mpl_heatmap(feat):
    """What ``feat_to_fig`` must equal: matplotlib's viridis bytes of the
    min-max normalised transposed data, flipped for ``origin="lower"``."""
    f = np.asarray(feat)
    f = f[0] if f.ndim == 3 else f
    return cm.viridis(Normalize()(f.T), bytes=True)[..., :3][::-1]


def _paras(tmp_path):
    return types.SimpleNamespace(
        config="exp.yaml", name=None, seed=0, logdir=str(tmp_path / "log"),
        ckpdir=str(tmp_path / "ckpt"), outdir=str(tmp_path / "out"),
        no_msg=False, cpu=True)


# --------------------------------------------------------------- util.py
@pytest.mark.parametrize("values", [
    [0, 1, 9.5, 999, 999.9, -3, -999],
    [1000, 1049, 1050, 1500, 9999, 12345, 999499, -1500],
    [1e6, 2_000_000, 1.26e9, 3e12, 4.5e15, 1e18, 0.05, 123.456]])
def test_human_format_matches_jax(values):
    for v in values:
        assert human_format(v) == jax_util.human_format(v), v


def test_timer_matches_jax(monkeypatch):
    """The same clock readings give the same table and the same line."""
    from end_to_end_asr_pytorch_tpu_torch.utils import util as port_util
    got, ref = [], []
    for mod, out in ((port_util, got), (jax_util, ref)):
        ticks = iter([0.0, 0.5, 0.5, 1.25, 1.25, 2.0, 2.0])
        monkeypatch.setattr(mod, "time",
                            types.SimpleNamespace(time=lambda: next(ticks)))
        t = mod.Timer()
        t.cnt("rd")
        t.cnt("fw")
        t.cnt("bw")
        out.append((t.click, dict(t.time_table), t.show(), t.click))
    assert got == ref


@pytest.mark.parametrize("case", ["td", "htd_first_head", "f64", "int",
                                  "constant", "nan", "long"])
def test_feat_to_fig_equals_matplotlib_viridis(case):
    rng = np.random.RandomState(3)
    feat = {"td": rng.rand(9, 5).astype(np.float32),
            "htd_first_head": rng.randn(2, 7, 4).astype(np.float32),
            "f64": rng.randn(6, 3),
            "int": rng.randint(-50, 50, (5, 8)),
            "constant": np.full((4, 3), 0.25, np.float32),
            "nan": np.where(rng.rand(5, 6) < 0.2, np.nan,
                            rng.rand(5, 6)).astype(np.float32),
            "long": rng.rand(176, 40).astype(np.float32) ** 4}[case]
    got = feat_to_fig(feat)
    assert got.dtype == np.uint8 and got.shape[2] == 3
    np.testing.assert_array_equal(got, _mpl_heatmap(feat))


@pytest.mark.parametrize("shape", [(1, 1), (7, 11), (176, 40)])
def test_png_decodes_with_pil_to_the_array(shape):
    img = np.random.RandomState(shape[0]).randint(
        0, 256, (*shape, 3)).astype(np.uint8)
    data = encode_png(img)
    got = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(got, img)
    assert png_size(data) == shape
    with pytest.raises(ValueError, match="uint8"):
        encode_png(img[..., :2])


# ---------------------------------------------------------- progress line
@pytest.mark.parametrize("step", [0, 950, 1500, 2_000_000])
def test_progress_line_equals_jax(tmp_path, capsys, step):
    ours = BaseSolver({"hparas": {}}, _paras(tmp_path))
    ref = JaxBase({}, _paras(tmp_path), "train")
    for s in (ours, ref):
        s.step = step
        s.progress("loss 1.000")
    got, want = capsys.readouterr().out.splitlines()
    assert got == want == f"[{jax_util.human_format(step)}] loss 1.000"


# -------------------------------------------------------- event files
@pytest.mark.parametrize("data", [b"", b"a", b"123456789", bytes(range(256)),
                                  bytes(np.random.RandomState(0).randint(
                                      0, 256, 4097, dtype=np.uint8))])
def test_crc32c_and_its_mask_match_tensorboardx(data):
    assert tb.crc32c(data) == tbx_crc32c(data)
    assert tb.masked_crc32c(data) == tbx_masked(data)


@pytest.mark.parametrize("step", [0, 7, 2**40])
def test_events_encode_as_tensorboardx_protos(step):
    """Byte for byte, the Event tensorboardX serialises for a scalar (0.0
    included: a oneof member), a text and the file version."""
    for value in (0.125, 0.0, -3.5):
        assert tb.event(12.5, step, [tb.scalar_value("loss", value)]) == \
            Event(summary=tbx_scalar("loss", value), wall_time=12.5,
                  step=step).SerializeToString()
    assert tb.event(12.5, step, [tb.text_value("hyp_0", "héllo wörld")]) == \
        Event(summary=tbx_text("hyp_0", "héllo wörld"), wall_time=12.5,
              step=step).SerializeToString()
    assert tb.event(3.0, file_version="brain.Event:2") == \
        Event(wall_time=3.0, file_version="brain.Event:2").SerializeToString()


def test_read_events_checks_every_crc(tmp_path):
    w = tb.SummaryWriter(tmp_path)
    w.add_text("t", "abc", 3)
    w.close()
    path = w.file_writer.path
    events = tb.read_events(path)
    assert events[0]["file_version"] == "brain.Event:2"
    assert events[1]["step"] == 3
    assert events[1]["values"][0]["tensor"]["string_val"] == ["abc"]
    raw = bytearray(path.read_bytes())
    for where in (len(raw) - 1, 9, len(raw) - 10):      # data, length, body
        bad = bytearray(raw)
        bad[where] ^= 0x01
        path.write_bytes(bytes(bad))
        with pytest.raises(ValueError, match="CRC|cut"):
            tb.read_events(path)
    path.write_bytes(bytes(raw[:-3]))
    with pytest.raises(ValueError, match="cut"):
        tb.read_events(path)


def _write_sequence(solver, feats, figure):
    """The calls the ASR solver's training loop and validation make."""
    solver.step = 100
    solver.write_log("loss", {"tr_loss": 1.5, "tr_ctc_loss": 2.25,
                              "tr_att_loss": None})
    solver.write_log("speed", {"utts_per_sec": 123.4567})
    solver.write_log("tf_rate", {"tf": 0.9})
    solver.step = 250
    solver.write_log("hyp_0", "alpha bravo")
    solver.write_log("ref_0", "alpha brave")
    for i, f in enumerate(feats):
        solver.write_log(f"align_{i}", figure(f))
    solver.write_log("wer", {"dv_att": 0.25, "dv_ctc": 0.5})
    solver.write_log("cer", {"dv_att": 0.0625, "dv_ctc": 0.125})
    solver.write_log("loss", {"dv_att": 0.75})
    solver.step = 1500
    solver.write_log("loss", {"tr_loss": 1.0, "tr_ctc_loss": 0.5})
    solver.write_log("hyp_0", "")


def _runs(logdir):
    """{run directory: EventAccumulator} of every directory holding an
    event file."""
    out = {}
    for f in sorted(Path(logdir).rglob("events.out.tfevents.*")):
        run = str(f.parent.relative_to(logdir))
        ea = EventAccumulator(str(f.parent), size_guidance={
            "scalars": 0, "images": 0, "tensors": 0})
        ea.Reload()
        out[run] = ea
    return out


def test_write_log_reads_back_as_the_jax_packages_tensorboardx_logs(tmp_path):
    """The same write_log calls through the JAX BaseSolver (tensorboardX)
    and the port's: the same sub-run directories, tags and steps,
    float32-equal scalars and equal texts; the port's figures decode to
    feat_to_fig's array (the JAX package's are rendered matplotlib
    figures with axes)."""
    rng = np.random.RandomState(5)
    feats = [rng.rand(12, 7).astype(np.float32),
             rng.rand(9, 5).astype(np.float32)]
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    ref = JaxBase({}, types.SimpleNamespace(
        config="exp.yaml", name=None, seed=0, logdir=str(jax_dir),
        ckpdir=str(tmp_path / "jc"), outdir=str(tmp_path / "jo"),
        no_msg=True), "train")
    _write_sequence(ref, feats, jax_util.feat_to_fig)
    ref.log.close()
    ours = BaseSolver({"hparas": {}}, types.SimpleNamespace(
        config="exp.yaml", name=None, seed=0, logdir=str(port_dir),
        ckpdir=str(tmp_path / "pc"), outdir=str(tmp_path / "po"),
        no_msg=True, cpu=True))
    _write_sequence(ours, feats, feat_to_fig)
    ours.close()
    want, got = _runs(jax_dir / "exp_sd0"), _runs(port_dir / "exp_sd0")
    assert sorted(got) == sorted(want)
    assert {"loss/tr_loss", "speed/utts_per_sec", "cer/dv_ctc"} <= set(got)
    for run in want:
        w, g = want[run], got[run]
        assert g.Tags() == w.Tags(), run
        for tag in w.Tags()["scalars"]:
            assert [(e.step, e.value) for e in g.Scalars(tag)] == \
                [(e.step, e.value) for e in w.Scalars(tag)], (run, tag)
        for tag in w.Tags()["tensors"]:
            assert g.SummaryMetadata(tag) == w.SummaryMetadata(tag)
            assert [(e.step, list(e.tensor_proto.string_val))
                    for e in g.Tensors(tag)] == \
                [(e.step, list(e.tensor_proto.string_val))
                 for e in w.Tensors(tag)], (run, tag)
        for tag in w.Tags()["images"]:
            assert [e.step for e in g.Images(tag)] == \
                [e.step for e in w.Images(tag)]
    main = got["."]
    for i, f in enumerate(feats):
        (im,) = main.Images(f"align_{i}")
        pixels = np.asarray(Image.open(io.BytesIO(im.encoded_image_string)))
        np.testing.assert_array_equal(pixels, _mpl_heatmap(f))
        assert (im.height, im.width) == f.T.shape
    # the scalars and texts also as log.jsonl lines, the images not
    lines = (port_dir / "exp_sd0" / "log.jsonl").read_text().splitlines()
    assert len(lines) == 10 and "align_0" not in "".join(lines)


def test_writer_flushes_on_its_period(tmp_path, monkeypatch):
    """Events reach the disk at the first write after ``flush_secs`` and
    on close, not before."""
    now = [1000.0]
    monkeypatch.setattr(time, "time", lambda: now[0])
    w = tb.SummaryWriter(tmp_path, flush_secs=180)
    size = w.file_writer.path.stat().st_size
    w.add_text("a", "x" * 100, 1)
    assert w.file_writer.path.stat().st_size == size
    now[0] += 181
    w.add_text("a", "y", 2)
    assert w.file_writer.path.stat().st_size > size
    w.close()
    assert [e["step"] for e in tb.read_events(w.file_writer.path)] == [0, 1, 2]


@pytest.mark.parametrize("use_pallas_train", [False, True])
def test_validation_writes_align_figures(tmp_path, use_pallas_train):
    """``main`` on a tiny corpus: validation logs ``align_i`` for the first
    DEV_N_EXAMPLE rows, each the heatmap of ``att_align[i, :, 0, :]`` of
    the teacher-forced pass (through K7's plain version with
    ``use_pallas_train``), a PNG of (T', U); plus hyp_i / ref_i texts and
    the scalar sub-runs."""
    from end_to_end_asr_pytorch_tpu_torch.solvers import train_asr
    from tests.test_torch_port_train import _train_config
    cfg = _train_config(tmp_path)
    c = yaml.safe_load(cfg.read_text())
    c["model"]["attention"]["use_pallas_train"] = use_pallas_train
    c["hparas"]["DEV_N_EXAMPLE"] = 2
    cfg.write_text(yaml.safe_dump(c))
    aligns = []
    valid_batch = train_asr.Solver.valid_batch

    def spy(self, *a, **k):
        out = valid_batch(self, *a, **k)
        aligns.append(out["att_align"].detach().numpy())
        return out

    train_asr.Solver.valid_batch = spy
    try:
        train.main(["--config", str(cfg), "--cpu", "--no-msg", "--logdir",
                    str(tmp_path / "log"), "--ckpdir", str(tmp_path / "ckpt")])
    finally:
        train_asr.Solver.valid_batch = valid_batch
    events = [e for f in (tmp_path / "log" / "cfg_sd0").glob("events.*")
              for e in tb.read_events(f)]
    figs = [(e["step"], v["tag"], v["image"]) for e in events
            for v in e.get("values", []) if "image" in v]
    texts = {v["tag"] for e in events for v in e.get("values", [])
             if "tensor" in v}
    assert texts == {"hyp_0/text_summary", "hyp_1/text_summary",
                     "ref_0/text_summary", "ref_1/text_summary"}
    # two validations at step 2 (valid_step, then the one after the loop)
    assert [(step, tag) for step, tag, _ in figs] == [
        (2, "align_0"), (2, "align_1")] * 2
    first = aligns[0]                      # the first validation's batch 0
    for i in range(2):
        im = figs[i][2]
        want = feat_to_fig(first[i, :, 0, :])
        assert png_size(im["png"]) == (first.shape[3], first.shape[1])
        np.testing.assert_array_equal(
            np.asarray(Image.open(io.BytesIO(im["png"]))), want)
    subruns = {str(f.parent.relative_to(tmp_path / "log" / "cfg_sd0"))
               for f in (tmp_path / "log" / "cfg_sd0").rglob("events.*")}
    assert {"loss/tr_loss", "speed/utts_per_sec", "tf_rate/tf", "wer/dv_att",
            "cer/dv_ctc", "."} <= subruns


# ------------------------------------------------------------- profiler
def test_benchmark_returns_the_jax_keys():
    x = torch.randn(16, 16)
    res = profiler.benchmark(lambda a: a @ a, x, iters=3, warmup=1,
                             batch_utts=4, audio_seconds=7.0)
    assert set(res) == {"ms_per_call", "calls_per_sec", "utts_per_sec",
                        "inv_rtf"}
    assert math.isclose(res["utts_per_sec"], 4 * res["calls_per_sec"])
    assert math.isclose(res["inv_rtf"], 7.0 * res["utts_per_sec"])
    assert set(profiler.benchmark(lambda: None, iters=2)) == {
        "ms_per_call", "calls_per_sec"}


def test_device_memory_without_a_card_and_trace_writes_json(tmp_path):
    assert profiler.device_memory() == {"cpu": {
        "bytes_in_use": -1, "peak_bytes_in_use": -1, "bytes_limit": -1}}
    with profiler.trace(str(tmp_path / "tr")) as path:
        torch.randn(32, 32) @ torch.randn(32, 32)
    import json
    trace = json.loads(path.read_text())
    assert path.parent == tmp_path / "tr" and trace["traceEvents"]


# ------------------------------------------------------------ corpus CLI
def _tree(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(Path(root).rglob("*")) if p.is_file()}


def test_corpus_cli_writes_the_jax_clis_bytes(tmp_path, monkeypatch):
    args = ["--n_train", "4", "--n_dev", "2", "--n_test", "2", "--grammar",
            "bigram", "--text_only", "8"]
    monkeypatch.setattr(sys, "argv", ["make_synthetic", "--out",
                                      str(tmp_path / "jax"), *args])
    jax_cli.main()
    root = make_synthetic.main(["--out", str(tmp_path / "port"), *args])
    assert root == tmp_path / "port"
    want = _tree(tmp_path / "jax")
    assert len(want) > 8 and "lm_text.txt" in want
    assert _tree(tmp_path / "port") == want


def test_corpus_cli_keeps_the_jax_flags_and_defaults():
    """Every flag of the JAX CLI, its default and its choices."""
    import argparse

    def actions(module):
        seen = {}
        orig = argparse.ArgumentParser.parse_args

        def grab(self, args=None, namespace=None):
            seen.update({a.dest: (a.default, a.choices, a.required)
                         for a in self._actions})
            raise SystemExit
        argparse.ArgumentParser.parse_args = grab
        try:
            with pytest.raises(SystemExit):
                module.main() if module is jax_cli else module.main([])
        finally:
            argparse.ArgumentParser.parse_args = orig
        return seen

    assert actions(make_synthetic) == actions(jax_cli)


# ------------------------------------------------------------- imports
def test_port_imports_no_instrument_package():
    """The port writes event files, PNGs and orbax directories itself: no
    module of it (nor chip_smoke.py) imports orbax, tensorboardX,
    tensorboard, matplotlib or PIL."""
    banned = {"orbax", "tensorboardX", "tensorboard", "matplotlib", "PIL"}
    files = sorted((ROOT / "end_to_end_asr_pytorch_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert {"utils/util.py", "utils/profiler.py", "utils/tensorboard.py",
            "utils/png.py", "utils/orbax.py", "data/make_synthetic.py"} <= {
        str(f.relative_to(ROOT / "end_to_end_asr_pytorch_tpu_torch"))
        for f in files[:-1]}
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad += [f"{f.relative_to(ROOT)}:{node.lineno} {n}" for n in names
                    if n.split(".")[0] in banned]
    assert not bad, bad


def test_summary_image_header_is_the_arrays_shape():
    img = feat_to_fig(np.random.RandomState(1).rand(10, 6))
    value = tb.image_value("align_0", img)
    e = Event()
    e.ParseFromString(tb.event(1.0, 4, [value]))
    im = e.summary.value[0].image
    assert (im.height, im.width, im.colorspace) == (6, 10, 3)
    assert struct.unpack(">II", im.encoded_image_string[16:24]) == (10, 6)
