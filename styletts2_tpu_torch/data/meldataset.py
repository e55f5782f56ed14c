"""Host-side data pipeline: file lists, audio IO, batching with shape buckets
(a copy of `styletts2_tpu/data/meldataset.py`, which cannot be imported
here: importing the JAX package imports JAX and PyYAML).

Train lists are `path|phonemes|speaker` lines; waves are padded with 5000
zeros at both ends and the mel length truncated to even; each item also
carries an OOD reference text (>= min_length characters) and a same-speaker
reference wave clipped to 192 frames; the collater zero-pads and sorts by
mel length. Mels are computed on the device by the trainer
(`ops/stft.preprocess_mel`), so the host ships only waves, token ids and
lengths; text and wave lengths are bucketed (32 tokens, 2 s).
"""

from __future__ import annotations

import os
import random
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from styletts2_tpu_torch.parallel.ddp import process_shard
from styletts2_tpu_torch.text import SYMBOL_TO_ID
from styletts2_tpu_torch.utils import read_wav, resample_sinc

HOP = 300
PAD_SAMPLES = 5000


def load_data_list(path: str) -> List[Tuple[str, str, int]]:
    items = []
    with open(path, encoding="utf-8", errors="ignore") as f:
        for line in f:
            parts = line.strip().split("|")
            if len(parts) >= 3:
                items.append((parts[0], parts[1], int(parts[2])))
            elif len(parts) == 2:
                items.append((parts[0], parts[1], 0))
    return items


def _bucket(n: int, step: int, lo: int, hi: Optional[int] = None) -> int:
    b = max(lo, ((n + step - 1) // step) * step)
    return min(b, hi) if hi is not None else b


@dataclass
class Batch:
    """One host batch; everything fixed-shape numpy, device-ready."""

    waves: np.ndarray  # (B, T_wav) float32, zero-padded
    wave_lengths: np.ndarray  # (B,)
    tokens: np.ndarray  # (B, T_text) int32
    input_lengths: np.ndarray  # (B,)
    ref_tokens: np.ndarray  # (B, T_ref) int32 (OOD texts)
    ref_lengths: np.ndarray  # (B,)
    mel_lengths: np.ndarray  # (B,) even mel frame counts
    ref_waves: np.ndarray  # (B, T_refwav) same-speaker reference audio
    ref_wave_lengths: np.ndarray  # (B,)
    speakers: np.ndarray  # (B,)


class FilePathDataset:
    def __init__(
        self,
        data_list: Sequence[Tuple[str, str, int]],
        root_path: str,
        sr: int = 24000,
        ood_texts: Optional[List[str]] = None,
        min_length: int = 50,
        validation: bool = False,
        max_mel_length: int = 192,
    ):
        self.data = list(data_list)
        self.root = root_path
        self.sr = sr
        self.min_length = min_length
        self.validation = validation
        self.max_mel_length = max_mel_length
        self.ood = ood_texts or []
        self.by_speaker: Dict[int, List[int]] = {}
        for i, (_, _, spk) in enumerate(self.data):
            self.by_speaker.setdefault(spk, []).append(i)

    def __len__(self):
        return len(self.data)

    def load_wave(self, path: str) -> np.ndarray:
        wave, sr = read_wav(os.path.join(self.root, path))
        if sr != self.sr:
            # windowed-sinc polyphase — same quality as the reference's
            # librosa load+resample (meldataset.py:58-66)
            wave = resample_sinc(wave, sr, self.sr)
        return np.concatenate(
            [np.zeros(PAD_SAMPLES, np.float32), wave, np.zeros(PAD_SAMPLES, np.float32)]
        )

    def tokenize(self, text: str) -> np.ndarray:
        ids = [SYMBOL_TO_ID[c] for c in text if c in SYMBOL_TO_ID]  # unknown ones dropped
        return np.asarray([0] + ids + [0], np.int32)

    def sample_ood(self, rng: random.Random) -> np.ndarray:
        ps = ""
        guard = 0
        while len(ps) < self.min_length and self.ood:
            ps = self.ood[rng.randrange(len(self.ood))]
            guard += 1
            if guard > 100:
                break
        return self.tokenize(ps) if ps else np.asarray([0, 0], np.int32)

    def get_item(self, idx: int, rng: random.Random):
        path, text, spk = self.data[idx]
        wave = self.load_wave(path)
        tokens = self.tokenize(text)
        mel_len = wave.shape[0] // HOP + 1
        mel_len -= mel_len % 2
        ref_idx = rng.choice(self.by_speaker[spk])
        ref_wave = self.load_wave(self.data[ref_idx][0])
        # clip reference to max_mel_length frames of audio
        max_ref = self.max_mel_length * HOP
        if ref_wave.shape[0] > max_ref:
            start = rng.randrange(ref_wave.shape[0] - max_ref)
            ref_wave = ref_wave[start : start + max_ref]
        return {
            "wave": wave,
            "tokens": tokens,
            "mel_len": mel_len,
            "ref_wave": ref_wave,
            "ref_tokens": self.sample_ood(rng),
            "speaker": spk,
        }


class DataLoader:
    """Bucketed batch iterator (shuffling, drop-last for training).

    Host throughput features (reference meldataset.py:184-189, 233-254):
      * length-grouped batching — a shuffled window of `length_group`
        batches is sorted by audio length before carving batches, so items
        in a batch share a wave bucket (less padding → less wasted chip
        time) while batch ORDER stays shuffled;
      * in-batch sort by mel length descending (the reference collater's
        sort, meldataset.py:184-189);
      * `prefetch` > 0 decodes ahead on a background thread (the reference
        uses multi-worker torch DataLoader) so host audio decode overlaps
        the device step.
    """

    def __init__(
        self,
        dataset: FilePathDataset,
        batch_size: int = 16,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 1,
        text_bucket: int = 32,
        wave_bucket: int = 2 * 24000,
        length_group: int = 8,
        prefetch: int = 2,
        num_workers: int = 2,
    ):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.text_bucket = text_bucket
        self.wave_bucket = wave_bucket
        self.length_group = max(1, length_group)
        self.prefetch = prefetch
        self.num_workers = max(1, num_workers)
        self.epoch = 0
        self._lengths: Optional[List[int]] = None

    def __len__(self):
        n = len(self.ds) // self.batch_size
        return n if self.drop_last else -(-len(self.ds) // self.batch_size)

    def _item_length(self, idx: int) -> int:
        """Cheap per-item length proxy for grouping: WAV header frame count
        (no decode)."""
        if self._lengths is None:
            self._lengths = [-1] * len(self.ds)
        if self._lengths[idx] < 0:
            path = os.path.join(self.ds.root, self.ds.data[idx][0])
            try:
                import wave as _wave

                with _wave.open(path, "rb") as f:
                    n = f.getnframes()
                    sr = f.getframerate()
                self._lengths[idx] = int(n * self.ds.sr / sr)
            except Exception:
                self._lengths[idx] = 0
        return self._lengths[idx]

    def _batch_index_plan(self, rng: random.Random) -> List[List[int]]:
        order = list(range(len(self.ds)))
        if self.shuffle:
            rng.shuffle(order)
        bs = self.batch_size
        if self.shuffle and self.length_group > 1:
            win = bs * self.length_group
            for w0 in range(0, len(order), win):
                chunk = order[w0 : w0 + win]
                chunk.sort(key=self._item_length, reverse=True)
                order[w0 : w0 + win] = chunk
        batches = [
            order[i : i + bs]
            for i in range(0, len(order) - (bs - 1 if self.drop_last else 0), bs)
        ]
        if self.shuffle:
            rng.shuffle(batches)
        return batches

    def __iter__(self) -> Iterator[Batch]:
        rng = random.Random(self.seed + self.epoch)
        self.epoch += 1
        batches = self._batch_index_plan(rng)

        def make(idxs: List[int]) -> Batch:
            items = [self.ds.get_item(j, rng) for j in idxs]
            return self.collate(items)

        if self.prefetch <= 0:
            for idxs in batches:
                yield make(idxs)
            return

        # background decode: a small pipeline of in-flight batches
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                for idxs in batches:
                    if stop.is_set():
                        return
                    q.put(make(idxs))
            except Exception as e:  # surface decode errors to the consumer
                q.put(e)
            finally:
                q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                got = q.get()
                if got is None:
                    break
                if isinstance(got, Exception):
                    raise got
                yield got
        finally:
            stop.set()
            # drain so the producer can exit its blocking put
            try:
                while True:
                    q.get_nowait()
            except Exception:
                pass

    def collate(self, items) -> Batch:
        B = len(items)
        # reference collater sorts by mel length descending
        # (meldataset.py:184-189)
        items = sorted(items, key=lambda it: it["mel_len"], reverse=True)
        t_max = _bucket(max(len(it["tokens"]) for it in items), self.text_bucket, self.text_bucket)
        r_max = _bucket(max(len(it["ref_tokens"]) for it in items), self.text_bucket, self.text_bucket)
        w_max = _bucket(max(len(it["wave"]) for it in items), self.wave_bucket, self.wave_bucket)
        rw_max = _bucket(max(len(it["ref_wave"]) for it in items), self.wave_bucket, self.wave_bucket)

        waves = np.zeros((B, w_max), np.float32)
        wave_lengths = np.zeros(B, np.int32)
        tokens = np.zeros((B, t_max), np.int32)
        input_lengths = np.zeros(B, np.int32)
        ref_tokens = np.zeros((B, r_max), np.int32)
        ref_lengths = np.zeros(B, np.int32)
        mel_lengths = np.zeros(B, np.int32)
        ref_waves = np.zeros((B, rw_max), np.float32)
        ref_wave_lengths = np.zeros(B, np.int32)
        speakers = np.zeros(B, np.int32)

        for b, it in enumerate(items):
            w, tk, rw, rt = it["wave"], it["tokens"], it["ref_wave"], it["ref_tokens"]
            waves[b, : len(w)] = w
            wave_lengths[b] = len(w)
            tokens[b, : len(tk)] = tk
            input_lengths[b] = len(tk)
            ref_tokens[b, : len(rt)] = rt
            ref_lengths[b] = len(rt)
            mel_lengths[b] = it["mel_len"]
            ref_waves[b, : len(rw)] = rw
            ref_wave_lengths[b] = len(rw)
            speakers[b] = it["speaker"]

        return Batch(
            waves=waves, wave_lengths=wave_lengths, tokens=tokens,
            input_lengths=input_lengths, ref_tokens=ref_tokens,
            ref_lengths=ref_lengths, mel_lengths=mel_lengths,
            ref_waves=ref_waves, ref_wave_lengths=ref_wave_lengths,
            speakers=speakers,
        )


def build_dataloader(
    path_list: str,
    root_path: str,
    ood_path: Optional[str] = None,
    min_length: int = 50,
    batch_size: int = 16,
    validation: bool = False,
    seed: int = 1,
    shard: Tuple[int, int] = (0, 1),
) -> DataLoader:
    """The reference's build_dataloader: shuffled, drop-last batches for
    training; in order, every item, for validation. `shard` (rank, world)
    gives a training loader rank's contiguous slice of the list
    (`parallel/ddp.process_shard`, the JAX loader's `shard_across_processes`);
    validation reads the whole list."""
    data = load_data_list(path_list)
    if not validation and shard[1] > 1:
        data = data[process_shard(len(data), *shard)]
    ood_texts = None
    if ood_path and os.path.exists(ood_path):
        with open(ood_path, encoding="utf-8", errors="ignore") as f:
            lines = f.readlines()
        if lines:
            idx = 1 if ".wav" in lines[0].split("|")[0] else 0
            ood_texts = [l.split("|")[idx].strip() for l in lines if l.strip()]
    ds = FilePathDataset(
        data, root_path, ood_texts=ood_texts, min_length=min_length,
        validation=validation,
    )
    return DataLoader(
        ds, batch_size=batch_size, shuffle=not validation,
        drop_last=not validation, seed=seed,
    )
