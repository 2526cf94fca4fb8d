"""LibriSpeech corpus walker (the port's copy of the JAX package's
``data/librispeech.py``): walks ``<path>/<split>/**/**.{flac,wav}``, parses the sibling
``*.trans.txt`` files, pre-encodes transcripts with the tokenizer, and
supports length-sorted bucketing. Transcripts are lowercased before encoding
(LibriSpeech ships uppercase; tokenizer vocabs here are lowercase).

Audio lengths for sorting come from file sizes (no decode on the sort path);
decoding happens lazily at batch time via data/audio_io.py (FLAC, WAV and
NPY).
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Sequence, Tuple

from .audio_io import load_audio, num_samples


def read_text(trans_file: Path) -> dict:
    out = {}
    for line in trans_file.read_text().splitlines():
        if not line.strip():
            continue
        utt_id, _, text = line.partition(" ")
        out[utt_id] = text.strip().lower()
    return out


class LibriDataset:
    """A split of LibriSpeech(-layout) data: list of (audio_path, text_ids).

    ``splits`` may be a list (e.g. ['train-clean-100', 'train-clean-360']);
    utterances are concatenated then length-sorted ascending (for
    bucketing).
    """

    def __init__(self, path: str, splits: Sequence[str] | str, tokenizer):
        if isinstance(splits, str):
            splits = [splits]
        self.tokenizer = tokenizer
        items: List[Tuple[Path, List[int], str]] = []
        for split in splits:
            split_dir = Path(path) / split
            if not split_dir.is_dir():
                raise FileNotFoundError(f"split not found: {split_dir}")
            for trans in sorted(split_dir.rglob("*.trans.txt")):
                texts = read_text(trans)
                for utt_id, text in texts.items():
                    audio = None
                    for ext in (".flac", ".wav", ".npy"):
                        cand = trans.parent / f"{utt_id}{ext}"
                        if cand.exists():
                            audio = cand
                            break
                    if audio is None:
                        continue
                    items.append((audio, tokenizer.encode(text), text))
        if not items:
            raise RuntimeError(f"no utterances found under {path} {splits}")
        # ascending audio length via file size (avoids decoding here)
        items.sort(key=lambda it: it[0].stat().st_size)
        self.items = items

    def __len__(self):
        return len(self.items)

    def load_wave(self, i: int):
        wave, sr = load_audio(str(self.items[i][0]))
        return wave

    def num_samples(self, i: int) -> int:
        """``len(load_wave(i))``, from the file's header where it says
        (decoding only a FLAC stream of unknown length)."""
        n = num_samples(str(self.items[i][0]))
        return len(self.load_wave(i)) if n is None else n

    def text_ids(self, i: int) -> List[int]:
        return self.items[i][1]

    def text_raw(self, i: int) -> str:
        return self.items[i][2]

    def utt_id(self, i: int) -> str:
        return self.items[i][0].stem
