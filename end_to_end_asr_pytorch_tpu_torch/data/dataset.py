"""Dataset loading and fixed-shape batching (the port's copy of the JAX
package's ``data/dataset.py``).

``load_dataset(...) -> (tr_set, dv_set, feat_dim, vocab_size, tokenizer,
msg)`` for ASR; ``load_textset(...) -> (tr_set, dv_set, vocab_size,
tokenizer, msg)`` for LM training (``TextBatchLoader``: text only,
length-sorted batches in a shuffled order). Audio batches carry raw
waveforms, padded so that the frame count is a multiple of
``frame_quantum`` (64 frames) and the label length a multiple of
``text_quantum`` (16 tokens): few distinct shapes. PCM16-exact waveforms
travel as int16 (the front end dequantizes them bit-exactly). Bucketing sorts
by length, chunks into batches and shuffles the batch order per epoch;
``shuffle=False`` gives the ascending order of curriculum learning.
"""
from __future__ import annotations

import itertools
import threading
from collections import OrderedDict, deque
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from .librispeech import LibriDataset
from ..parallel import mesh
from ..ops.audio import create_transform
from ..utils.text import load_text_encoder

DEFAULT_CACHE_BYTES = 2 << 30  # 2 GiB of decoded waveforms
HOP = 160  # 10 ms at 16 kHz; kept in sync with ops/audio defaults


class LRUWaveCache:
    """Byte-budget LRU for decoded waveforms; items larger than the whole
    budget are never cached. Thread-safe (the n_jobs pool shares it)."""

    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)
        self._items: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self.nbytes = 0
        self._lock = threading.Lock()

    def get(self, key: int) -> Optional[np.ndarray]:
        with self._lock:
            w = self._items.get(key)
            if w is not None:
                self._items.move_to_end(key)
            return w

    def put(self, key: int, wave: np.ndarray) -> None:
        nb = wave.nbytes
        with self._lock:
            if nb > self.max_bytes or key in self._items:
                return
            while self.nbytes + nb > self.max_bytes and self._items:
                _, old = self._items.popitem(last=False)
                self.nbytes -= old.nbytes
            self._items[key] = wave
            self.nbytes += nb

    def __len__(self):
        return len(self._items)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class AudioBatchLoader:
    """Iterable over fixed-shape numpy batches: wave, wave_len, text,
    text_len, name, text_raw."""

    def __init__(self, dataset: LibriDataset, batch_size: int,
                 frame_quantum: int = 64, text_quantum: int = 16,
                 shuffle: bool = True, ascending: bool = False,
                 seed: int = 0, cache_waves: bool = True, n_jobs: int = 0,
                 bucketing: bool = True,
                 cache_bytes: int = DEFAULT_CACHE_BYTES,
                 rank: int = 0, world: int = 1,
                 multiple: Optional[int] = None):
        self.ds = dataset
        self.batch_size = batch_size
        self.rank, self.world = rank, world
        self.multiple = world if multiple is None else multiple
        self.n_jobs = n_jobs
        self.frame_quantum = frame_quantum
        self.text_quantum = text_quantum
        self.shuffle = shuffle and not ascending
        self.ascending = ascending
        self.rng = np.random.RandomState(seed)
        self._wave_cache: Optional[LRUWaveCache] = (
            LRUWaveCache(cache_bytes) if cache_waves and cache_bytes > 0
            else None)
        n = len(dataset)
        idx = list(range(n))  # the dataset is sorted ascending by size
        if not bucketing:
            self.rng.shuffle(idx)
        self.batches = [idx[i:i + batch_size] for i in range(0, n, batch_size)]

    def __len__(self):
        return len(self.batches)

    @staticmethod
    def _pack_i16(w: np.ndarray) -> np.ndarray:
        """PCM16-exact waveforms as int16 (half the cache and the transfer);
        anything else stays float32."""
        if w.dtype == np.int16:
            return w
        s = w.astype(np.float64) * 32768.0
        if (s.size and -32768.0 <= s.min() and s.max() <= 32767.0
                and np.array_equal(s, np.rint(s))):
            return s.astype(np.int16)
        return w

    def _wave(self, i: int) -> np.ndarray:
        if self._wave_cache is not None:
            w = self._wave_cache.get(i)
            if w is None:
                w = self._pack_i16(self.ds.load_wave(i))
                self._wave_cache.put(i, w)
            return w
        return self._pack_i16(self.ds.load_wave(i))

    def _pad_samples(self, s_max: int) -> int:
        t_pad = _round_up(s_max // HOP + 1, self.frame_quantum)
        s_pad = (t_pad - 1) * HOP
        if s_pad < s_max:
            t_pad += self.frame_quantum
            s_pad = (t_pad - 1) * HOP
        return s_pad

    def make_batch(self, ids: List[int]) -> Dict[str, Any]:
        """The batch of dataset rows ``ids``; over several ranks, this
        rank's rows of it (``_rank_rows``)."""
        if self.multiple == 1:
            return self._assemble(ids)
        rows, lo, hi = _rank_rows(ids, self.rank, self.world, self.multiple)
        s_max = max(self.ds.num_samples(i) for i in ids)
        u_max = max(len(self.ds.text_ids(i)) for i in ids)
        b = self._assemble(rows, s_max, u_max)
        b["rows"] = (lo, hi, len(ids))
        return b

    def _assemble(self, ids: List[Optional[int]], s_max: Optional[int] = None,
                  u_max: Optional[int] = None) -> Dict[str, Any]:
        """Rows ``ids`` (``None``: a zero-length dummy row), padded to the
        longest of them or to ``s_max`` samples and ``u_max`` labels."""
        waves = [np.zeros(0, np.int16) if i is None else self._wave(i)
                 for i in ids]
        texts = [[] if i is None else self.ds.text_ids(i) for i in ids]
        if s_max is None:
            s_max = max(len(w) for w in waves)
        elif max(len(w) for w in waves) > s_max:
            raise ValueError(f"a wave of rows {ids} is longer than its "
                             f"file's header says ({s_max} samples)")
        s_pad = self._pad_samples(s_max)
        u_pad = _round_up(max(len(t) for t in texts) if u_max is None
                          else u_max, self.text_quantum)
        B = len(ids)
        wave_dtype = (np.int16 if all(w.dtype == np.int16 for w in waves)
                      else np.float32)
        if wave_dtype == np.float32:
            waves = [w.astype(np.float32) / 32768.0
                     if w.dtype == np.int16 else w for w in waves]
        wave = np.zeros((B, s_pad), wave_dtype)
        wave_len = np.zeros((B,), np.int32)
        text = np.zeros((B, u_pad), np.int32)
        text_len = np.zeros((B,), np.int32)
        for b, (w, t) in enumerate(zip(waves, texts)):
            wave[b, :len(w)] = w
            wave_len[b] = len(w)
            text[b, :len(t)] = t
            text_len[b] = len(t)
        return {"wave": wave, "wave_len": wave_len, "text": text,
                "text_len": text_len,
                "name": ["" if i is None else self.ds.utt_id(i) for i in ids],
                "text_raw": ["" if i is None else self.ds.text_raw(i)
                             for i in ids]}

    def epoch_iter(self, shuffle: Optional[bool] = None
                   ) -> Iterator[Dict[str, Any]]:
        """One epoch in shuffled batch order, or ascending with
        shuffle=False. With n_jobs > 0 a pool of n_jobs threads assembles up
        to 2*n_jobs batches ahead, delivered in order; closing the generator
        early cancels the pending work."""
        order = list(range(len(self.batches)))
        if self.shuffle if shuffle is None else shuffle:
            self.rng.shuffle(order)
        if self.n_jobs <= 0:
            for bi in order:
                yield self.make_batch(self.batches[bi])
            return
        from concurrent.futures import ThreadPoolExecutor
        window = max(2, 2 * self.n_jobs)
        ex = ThreadPoolExecutor(max_workers=self.n_jobs)
        futs: "deque" = deque()
        it = iter(order)
        try:
            for bi in itertools.islice(it, window):
                futs.append(ex.submit(self.make_batch, self.batches[bi]))
            while futs:
                item = futs.popleft().result()
                nxt = next(it, None)
                if nxt is not None:
                    futs.append(ex.submit(self.make_batch, self.batches[nxt]))
                yield item
        finally:
            while futs:
                futs.popleft().cancel()
            ex.shutdown(wait=False, cancel_futures=True)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        return self.epoch_iter()


def _rank_rows(ids: List[int], rank: int, world: int, multiple: int):
    """(rows ``[lo, hi)`` of data index ``rank`` of ``world`` in ``ids``
    padded to a multiple of ``multiple`` (all the ranks, a multiple of
    ``world``) with ``None`` dummies, as ``parallel/mesh.pad_batch_to``
    pads, lo, hi)."""
    padded = list(ids) + [None] * ((-len(ids)) % multiple)
    lo, hi = mesh.row_range(len(padded), rank, world)
    return padded[lo:hi], lo, hi


def _make_corpus(corpus_cfg: Dict[str, Any], splits, tokenizer) -> LibriDataset:
    name = corpus_cfg.get("name", "librispeech").lower()
    if name in ("librispeech", "synthetic"):  # synthetic uses libri layout
        return LibriDataset(corpus_cfg["path"], splits, tokenizer)
    raise NotImplementedError(f"corpus {name!r}")


def load_dataset(n_jobs: int, ascending: bool, corpus: Dict[str, Any],
                 audio: Dict[str, Any], text: Dict[str, Any],
                 mode: str = "train", frame_quantum: int = 64,
                 rank: int = 0, world: int = 1,
                 multiple: Optional[int] = None):
    """``mode="train"``: (tr_set, dv_set, feat_dim, vocab_size, tokenizer,
    msg), ``ascending`` giving the train set curriculum order.
    ``mode="test"``: the dev and test splits in that place, both unshuffled
    (``corpus.test_split`` defaults to ``dev_split``). Over ``world``
    ranks, ``corpus.batch_size`` is the global batch and each loader
    yields rank ``rank``'s rows of it, padded first to a multiple of
    ``multiple`` (default ``world``; under tensor parallelism every rank,
    ``world`` being the data ranks)."""
    tokenizer = load_text_encoder(text["mode"], text["vocab_file"])
    _, feat_dim = create_transform(audio)
    bs = int(corpus.get("batch_size", 8))
    bucketing = bool(corpus.get("bucketing", True))
    cache_bytes = int(corpus.get("cache_bytes", DEFAULT_CACHE_BYTES))
    shard = dict(rank=rank, world=world, multiple=multiple)
    if mode == "train":
        tr_ds = _make_corpus(corpus, corpus["train_split"], tokenizer)
        tr_set = AudioBatchLoader(tr_ds, bs, frame_quantum=frame_quantum,
                                  shuffle=not ascending, ascending=ascending,
                                  n_jobs=n_jobs, bucketing=bucketing,
                                  cache_bytes=cache_bytes, **shard)
        dv_ds = _make_corpus(corpus, corpus["dev_split"], tokenizer)
    else:
        tr_ds = _make_corpus(corpus, corpus["dev_split"], tokenizer)
        tr_set = AudioBatchLoader(tr_ds, bs, frame_quantum=frame_quantum,
                                  shuffle=False, cache_bytes=cache_bytes,
                                  **shard)
        dv_ds = _make_corpus(corpus, corpus.get("test_split",
                                                corpus["dev_split"]), tokenizer)
    dv_set = AudioBatchLoader(dv_ds, bs, frame_quantum=frame_quantum,
                              shuffle=False, cache_bytes=cache_bytes, **shard)
    a_name, b_name = ("train", "dev") if mode == "train" else ("dev", "test")
    msg = [
        f"I/O spec  | audio feat = {audio.get('feat_type', 'fbank')} "
        f"(dim {feat_dim}) | tokenizer = {text['mode']} "
        f"(vocab {tokenizer.vocab_size})",
        f"Corpus    | {corpus.get('name')} at {corpus['path']} | "
        f"{a_name} {len(tr_ds)} utts / {b_name} {len(dv_ds)} utts | batch {bs}",
    ]
    return tr_set, dv_set, feat_dim, tokenizer.vocab_size, tokenizer, msg


class TextBatchLoader:
    """LM batches ``{"text", "text_len"}``: the dataset sorted by token
    count (stably), cut into batches, the text padded to a multiple of
    ``text_quantum``; each epoch walks the batches in an order shuffled by
    ``np.random.RandomState(seed)`` (``shuffle=False``: ascending)."""

    def __init__(self, dataset, batch_size: int, text_quantum: int = 16,
                 shuffle: bool = True, seed: int = 0, rank: int = 0,
                 world: int = 1, multiple: Optional[int] = None):
        self.ds = dataset
        self.rank, self.world = rank, world
        self.multiple = world if multiple is None else multiple
        self.batch_size = batch_size
        self.text_quantum = text_quantum
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        idx = sorted(range(len(dataset)), key=lambda i: len(dataset.text_ids(i)))
        self.batches = [idx[i:i + batch_size]
                        for i in range(0, len(idx), batch_size)]

    def __len__(self):
        return len(self.batches)

    def make_batch(self, ids: List[int]) -> Dict[str, Any]:
        """The batch of rows ``ids``; over several ranks, this rank's rows
        of it, padded to the global batch's longest text, with ``rows``
        as the audio batches carry it and the global batch's ``tokens``."""
        u_max = max(len(self.ds.text_ids(i)) for i in ids)
        out = {}
        if self.multiple > 1:
            out["tokens"] = sum(len(self.ds.text_ids(i)) for i in ids)
            n = len(ids)
            ids, lo, hi = _rank_rows(ids, self.rank, self.world,
                                     self.multiple)
            out["rows"] = (lo, hi, n)
        texts = [[] if i is None else self.ds.text_ids(i) for i in ids]
        u_pad = _round_up(u_max, self.text_quantum)
        text = np.zeros((len(ids), u_pad), np.int32)
        text_len = np.zeros((len(ids),), np.int32)
        for b, t in enumerate(texts):
            text[b, :len(t)] = t
            text_len[b] = len(t)
        return {"text": text, "text_len": text_len, **out}

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        order = list(range(len(self.batches)))
        if self.shuffle:
            self.rng.shuffle(order)
        for bi in order:
            yield self.make_batch(self.batches[bi])


class TextLineDataset:
    """Sentences, one a line, lower-cased, from text files under ``path``
    (a split entry ending in ``.txt``, e.g. the synthetic generator's
    ``lm_text.txt``), with the ``text_ids`` / ``text_raw`` interface
    ``TextBatchLoader`` reads."""

    def __init__(self, path: str, files, tokenizer):
        self.tokenizer = tokenizer
        lines: List[str] = []
        for f in files:
            lines += [ln.strip().lower() for ln in
                      (Path(path) / f).read_text().splitlines() if ln.strip()]
        if not lines:
            raise RuntimeError(f"no text lines under {path} {list(files)}")
        self._raw = lines
        self._ids = [tokenizer.encode(ln) for ln in lines]

    def __len__(self):
        return len(self._ids)

    def text_ids(self, i: int) -> List[int]:
        return self._ids[i]

    def text_raw(self, i: int) -> str:
        return self._raw[i]


def _make_textset(corpus_cfg: Dict[str, Any], splits, tokenizer):
    """Text-line files when every split entry ends in ``.txt``, a corpus's
    transcripts when none does; a mix raises."""
    if isinstance(splits, str):
        splits = [splits]
    n_txt = sum(str(s).endswith(".txt") for s in splits)
    if n_txt == len(splits):
        return TextLineDataset(corpus_cfg["path"], splits, tokenizer)
    if n_txt:
        raise ValueError(
            f"cannot mix text-line files and transcript splits: {splits}")
    return _make_corpus(corpus_cfg, splits, tokenizer)


def load_textset(corpus: Dict[str, Any], text: Dict[str, Any],
                 rank: int = 0, world: int = 1,
                 multiple: Optional[int] = None):
    """LM training data: (tr_set, dv_set, vocab_size, tokenizer, msg), the
    train set shuffled per epoch, the dev set in ascending order
    (``corpus.batch_size`` defaults to 32, the global batch over ``world``
    ranks: each loader yields rank ``rank``'s rows, padded first to a
    multiple of ``multiple`` as ``load_dataset``'s)."""
    tokenizer = load_text_encoder(text["mode"], text["vocab_file"])
    bs = int(corpus.get("batch_size", 32))
    tr_ds = _make_textset(corpus, corpus["train_split"], tokenizer)
    dv_ds = _make_textset(corpus, corpus["dev_split"], tokenizer)
    msg = [f"LM corpus | train {len(tr_ds)} / dev {len(dv_ds)} sentences | "
           f"vocab {tokenizer.vocab_size}"]
    shard = dict(rank=rank, world=world, multiple=multiple)
    return (TextBatchLoader(tr_ds, bs, **shard),
            TextBatchLoader(dv_ds, bs, shuffle=False, **shard),
            tokenizer.vocab_size, tokenizer, msg)
