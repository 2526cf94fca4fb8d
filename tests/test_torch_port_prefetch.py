"""The port's input pipeline (``parallel/mesh.py`` ``prefetch_to_device``)
on the CPU, held to the inline copy the solvers made before it and to the
JAX package's ``prefetch_to_device``: batches in order with their values,
dtypes and host halves; a producer error surfacing after the batches
already yielded; an early close stopping the worker, closing the source
in the worker's thread and shutting the loader's pool down; the bound on
batches ahead of the consumer and on batches held, also with two
prefetchers alive at once; and a ``main`` run that stops mid-epoch
leaving no thread behind. Values compare exactly (the same arrays)."""
import threading
import time
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from end_to_end_asr_pytorch_tpu.data.dataset import (
    load_dataset as jax_load_dataset, load_textset as jax_load_textset)
from end_to_end_asr_pytorch_tpu.parallel import mesh as jax_mesh
from end_to_end_asr_pytorch_tpu_torch import train
from end_to_end_asr_pytorch_tpu_torch.data.dataset import (load_dataset,
                                                           load_textset)
from end_to_end_asr_pytorch_tpu_torch.data.synthetic import generate_corpus
from end_to_end_asr_pytorch_tpu_torch.parallel import mesh
from end_to_end_asr_pytorch_tpu_torch.solvers.train_lm import LM_KEYS

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
WAIT_S = 5.0          # the longest a test waits for threads to end


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("prefetch_synth")
    return generate_corpus(str(root), n_train=12, n_dev=4, n_test=0,
                           seed=3, text_only=40)


def _data(corpus):
    return {"corpus": {"name": "synthetic", "path": str(corpus),
                       "train_split": ["train-clean"],
                       "dev_split": ["dev-clean"], "batch_size": 3},
            "audio": {"feat_type": "fbank", "feat_dim": 40},
            "text": {"mode": "character",
                     "vocab_file": str(corpus / "vocab.txt")}}


def _loaders(kind, corpus, n_jobs=2):
    """(train loader, the keys its steps read) of the port."""
    data = _data(corpus)
    if kind == "asr":
        return load_dataset(n_jobs, False, **data)[0], mesh.ASR_KEYS
    lm_corpus = dict(data["corpus"], train_split=["lm_text.txt"],
                     batch_size=8)
    return load_textset(lm_corpus, data["text"])[0], LM_KEYS


def _epochs(loader, n=2):
    for _ in range(n):
        yield from loader


def _inline(batch, keys):
    """What the solvers copied inline before the prefetcher: the arrays
    through ``torch.from_numpy(...).to(device)``, labels as int64."""
    dtypes = {"text": torch.int64, "text_len": torch.int64}
    return {k: torch.from_numpy(batch[k]).to("cpu", dtypes.get(k))
            for k in keys if k in batch}


def _threads(name):
    return [t for t in threading.enumerate() if t.name.startswith(name)]


def _wait_until(cond, limit=WAIT_S):
    end = time.monotonic() + limit
    while not cond() and time.monotonic() < end:
        time.sleep(0.02)
    return cond()


@pytest.mark.parametrize("kind", ["asr", "lm"])
def test_prefetch_to_device_matches_inline_path(corpus, kind):
    """Two epochs of shuffled order: the prefetched batches are the inline
    path's, in order, with its values and dtypes, and the host halves are
    the loader's batches as they came."""
    got_loader, keys = _loaders(kind, corpus)
    ref_loader, _ = _loaders(kind, corpus)
    got = list(mesh.prefetch_to_device(_epochs(got_loader), "cpu",
                                       keys=keys))
    ref = list(_epochs(ref_loader))
    assert len(got) == len(ref) > 2
    for (dev, host), src in zip(got, ref):
        want = _inline(src, keys)
        assert set(dev) == set(want) == set(keys)
        for k, t in want.items():
            assert dev[k].dtype == t.dtype and dev[k].device.type == "cpu"
            assert torch.equal(dev[k], t), k
        assert host.keys() == src.keys()
        for k, v in src.items():
            if isinstance(v, np.ndarray):
                assert isinstance(host[k], np.ndarray)
                assert host[k].dtype == v.dtype
                np.testing.assert_array_equal(host[k], v)
            else:
                assert host[k] == v
    if kind == "asr":
        assert got[0][0]["wave"].dtype == torch.int16   # PCM16 stays int16


@pytest.mark.parametrize("kind", ["asr", "lm"])
def test_host_batches_equal_the_jax_prefetcher(corpus, kind):
    """The port's prefetcher over the port's loader yields the host batches
    the JAX ``prefetch_to_device`` yields over the JAX loader (a mesh of
    one device, multiple 1: no padding), in the same shuffled order."""
    data = _data(corpus)
    if kind == "asr":
        port = load_dataset(2, False, **data)[0]
        ref = jax_load_dataset(2, False, False, False, data["corpus"],
                               data["audio"], data["text"])[0]
    else:
        lm_corpus = dict(data["corpus"], train_split=["lm_text.txt"],
                         batch_size=8)
        port = load_textset(lm_corpus, data["text"])[0]
        ref = jax_load_textset(1, False, False, lm_corpus, data["text"])[0]
    jmesh = jax_mesh.make_mesh(1)
    for _ in range(2):
        got = [h for _, h in mesh.prefetch_to_device(iter(port), "cpu")]
        want = [h for _, h in jax_mesh.prefetch_to_device(iter(ref), jmesh,
                                                          1)]
        assert len(got) == len(want) > 1
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                np.testing.assert_array_equal(np.asarray(g[k]),
                                              np.asarray(w[k]), err_msg=k)


def test_prefetch_to_device_propagates_worker_errors():
    """A producer failure surfaces in the consumer after the batches that
    came before it, not as a short epoch."""
    def bad_batches():
        yield {"wave": np.zeros((8, 4), np.int16)}
        yield {"wave": np.ones((8, 4), np.int16)}
        raise RuntimeError("corrupt utterance")

    it = mesh.prefetch_to_device(bad_batches(), "cpu")
    assert int(next(it)[0]["wave"].sum()) == 0
    assert int(next(it)[0]["wave"].sum()) == 32
    with pytest.raises(RuntimeError, match="corrupt utterance"):
        next(it)
    assert _wait_until(lambda: not _threads("prefetch_to_device"))


def test_prefetch_to_device_early_abandon_stops_worker():
    """Closing the consumer (a max_step break mid-epoch) stops the worker,
    which was waiting for a free slot, instead of leaving it behind."""
    produced = []

    def many_batches():
        for i in range(100):
            produced.append(i)
            yield {"text": np.full((8, 4), i, np.int32)}

    before = threading.active_count()
    it = mesh.prefetch_to_device(many_batches(), "cpu", depth=2)
    next(it)
    it.close()
    assert _wait_until(lambda: threading.active_count() <= before), \
        "worker thread leaked"
    assert len(produced) < 100


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_source_runs_at_most_depth_batches_ahead(depth):
    """A slow consumer: after it has taken k batches the source has made
    k + depth (it runs ahead, holding a slot for each batch staged), never
    more; the bound of the JAX queue is depth + 1."""
    produced = []

    def source():
        for i in range(12):
            produced.append(i)
            yield {"text": np.full((2, 3), i, np.int32)}

    it = mesh.prefetch_to_device(source(), "cpu", depth=depth)
    for k in range(1, 7):
        dev, host = next(it)
        assert int(dev["text"][0, 0]) == k - 1 == int(host["text"][0, 0])
        assert _wait_until(lambda: len(produced) >= k + depth, 2.0)
        time.sleep(0.05)
        assert len(produced) == k + depth
    it.close()


def test_two_prefetchers_hold_at_most_two_depths(monkeypatch):
    """Validation inside a training epoch: a second prefetcher runs while
    the first is alive. Neither deadlocks, and the batches staged and not
    yet dropped never pass 2 x depth."""
    depth, alive, staged = 2, set(), [0]
    stage = mesh.stage_batch

    def counted(*a, **k):
        dev, host, event = stage(*a, **k)
        n = staged[0] = staged[0] + 1
        alive.add(n)
        weakref.finalize(dev["text"], alive.discard, n)
        return dev, host, event

    monkeypatch.setattr(mesh, "stage_batch", counted)

    def source(tag, n):
        for i in range(n):
            yield {"text": np.full((2, 3), tag * 100 + i, np.int32)}

    train_it = mesh.prefetch_to_device(source(1, 8), "cpu", depth=depth)
    for i in range(3):
        dev, _ = next(train_it)
        assert int(dev["text"][0, 0]) == 100 + i
        del dev
        if i == 1:                       # a validation pass mid-epoch
            for j, (vdev, _) in enumerate(mesh.prefetch_to_device(
                    source(2, 6), "cpu", depth=depth)):
                assert int(vdev["text"][0, 0]) == 200 + j
                del vdev
                time.sleep(0.02)
                assert len(alive) <= 2 * depth
    rest = [int(d["text"][0, 0]) for d, _ in train_it]
    assert rest == [103, 104, 105, 106, 107]
    assert _wait_until(lambda: not alive, 2.0)


def test_close_runs_the_source_finally_in_the_worker(corpus):
    """Closing early closes the source generator in the worker's own
    thread: its ``finally`` runs there, so ``epoch_iter`` shuts its pool
    down, and the thread count returns to its level before."""
    loader, _ = _loaders("asr", corpus, n_jobs=2)
    before = threading.active_count()
    closed_in = []

    def source():
        try:
            yield from loader.epoch_iter(shuffle=True)
        finally:
            closed_in.append(threading.current_thread().name)

    it = mesh.prefetch_to_device(source(), "cpu")
    next(it)
    assert _threads("ThreadPoolExecutor")      # the loader's pool is up
    it.close()
    assert closed_in == ["prefetch_to_device"]
    assert _wait_until(lambda: threading.active_count() <= before), \
        [t.name for t in threading.enumerate()]


def test_main_stopping_mid_epoch_leaves_no_thread(corpus, tmp_path):
    """``main`` whose max_step ends mid-epoch (4 batches an epoch, 2
    steps, validation at step 1 while the training prefetcher is alive)
    returns with no prefetch or loader pool thread left."""
    cfg = yaml.safe_load((ROOT / "config/synthetic/las.yaml").read_text())
    cfg["data"] = dict(_data(corpus), audio=cfg["data"]["audio"])
    cfg["model"]["encoder"]["dim"] = [16, 16]
    cfg["model"]["attention"].update(dim=8, loc_kernel_size=6,
                                     loc_kernel_num=2)
    cfg["model"]["decoder"]["dim"] = 16
    cfg["hparas"].update(max_step=2, valid_step=1)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    before = threading.active_count()
    train.main(["--config", str(path), "--cpu", "--no-msg", "--njobs", "2",
                "--logdir", str(tmp_path / "log"), "--ckpdir",
                str(tmp_path / "ckpt")])
    assert (tmp_path / "ckpt" / "cfg_sd0" / "latest.pth").exists()
    assert not _threads("prefetch_to_device")
    assert _wait_until(lambda: threading.active_count() <= before), \
        [t.name for t in threading.enumerate()]
