"""Host-side input pipeline: crop/augment workers + device prefetch.

Replaces batchgenerators' MultiThreadedAugmenter process pool (reference:
toy_datamodule_3D.py:369-523). TPU hosts feed the chip: batch assembly
(random crop, random rater choice, mirror/noise augmentation) runs on host
CPU with a background prefetch thread double-buffering batches while the
device computes (SURVEY.md §2.7 "intra-node worker parallelism").

Reproduced statistical contract (not bit-parity with torch RNG):
- per-epoch shuffle seeded by the epoch counter (``RandomState(num_restarted)``,
  toy_datamodule_3D.py:420-431),
- one randomly chosen rater label per sample per epoch (:469),
- random crop start ~ randint(0, shape-patch) per axis (batchgenerators
  ``crop(..., crop_type='random')``),
- MirrorTransform: each spatial axis flipped with p=0.5 per sample,
- GaussianNoiseTransform: additive N(0, s) with s ~ U(0, 0.1) (the
  batchgenerators "variance"-as-scale quirk, augment_gaussian_noise).

Batches are channels-last: data (B, p, p, p, 1) float32, seg (B, p, p, p).

Worker parallelism (``num_workers >= 1``, the MultiThreadedAugmenter's
``num_processes`` analog): sample assembly fans out over a thread pool —
np.load IO and the native C++ crop/mirror/noise ops release the GIL, so
threads scale where pure-Python augmentation would not. Determinism is
worker-count-independent: each sample draws from its own RandomState
seeded by (seed, epoch, position-in-epoch), so ``num_workers=1`` and
``num_workers=16`` produce bit-identical batches. ``num_workers=0``
keeps the legacy sequential stream (one shared per-epoch RandomState).

The port's copy of ``values_tpu/data/pipeline.py``: the same seeds give
byte-equal batches, with ``augment=True`` too. The mirror and the noise
run in the port's own build of the native ops (:mod:`.native`, which
raises if g++ cannot build them); the decisions (which axes, the noise's
scale and seed) are drawn from the sample's RandomState, as there.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from . import native


class NumpyBatchLoader:
    """Finite per-epoch iterator over training or validation batches."""

    def __init__(self, samples: Sequence[Dict], batch_size: int,
                 patch_size: int, training: bool = True,
                 augment: bool = False, seed: int = 42,
                 prefetch: int = 2, drop_last: bool = False,
                 num_workers: int = 0):
        self.samples = list(samples)
        self.augment = augment
        self.batch_size = batch_size
        self.patch_size = patch_size
        self.training = training
        self.seed = seed
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.num_workers = int(num_workers or 0)
        self.num_restarted = 0
        self._pool: Optional[ThreadPoolExecutor] = None

    def _executor(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self.num_workers,
                thread_name_prefix="values-tpu-loader")
        return self._pool

    def __len__(self) -> int:
        n = len(self.samples)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    # -- single-sample assembly ---------------------------------------
    def _load_sample(self, sample: Dict, rs: np.random.RandomState):
        image = np.load(sample["image_path"], mmap_mode="r")
        label_path = None
        if sample.get("label_paths"):
            # the reference picks one random rater in BOTH train and val
            # (toy_datamodule_3D.py:469, random.choice in
            # generate_train_batch regardless of `training`)
            label_path = sample["label_paths"][
                rs.randint(len(sample["label_paths"]))]
        if self.training:
            p = self.patch_size
            # inclusive upper bound dim-p: batchgenerators' random crop
            # samples randint(0, dim-p+1), so the last valid offset is
            # reachable (ADVICE r1: exclusive bound under-sampled the
            # high edge)
            starts = [
                rs.randint(0, dim - p + 1) if dim > p else 0
                for dim in image.shape[:3]]
            sl = tuple(slice(s, s + p) for s in starts)
            image_patch = np.asarray(image[sl], dtype=np.float32)
            label_patch = None
            if label_path is not None:
                label_patch = np.asarray(
                    np.load(label_path, mmap_mode="r")[sl], dtype=np.int32)
            if self.augment:
                image_patch, label_patch = self._augment(
                    image_patch, label_patch, rs)
            return image_patch, label_patch, label_path
        # validation: fixed window
        crop = sample["crop_idx"]
        sl = tuple(slice(c[0], c[1]) for c in crop)
        image_patch = np.asarray(image[sl], dtype=np.float32)
        label_patch = None
        if label_path is not None:
            label_patch = np.asarray(
                np.load(label_path, mmap_mode="r")[sl], dtype=np.int32)
        return image_patch, label_patch, label_path

    @staticmethod
    def _augment(image: np.ndarray, label: Optional[np.ndarray],
                 rs: np.random.RandomState):
        """MirrorTransform then GaussianNoiseTransform (``_augment``,
        :112-130): per axis a flip with p = 0.5, a noise scale ~ U(0,
        0.1) and a noise seed, all from ``rs``; the arrays are copied
        first (a crop may be a view of the memory-mapped file)."""
        flips = sum((1 << axis) for axis in range(3) if rs.uniform() < 0.5)
        scale = rs.uniform(0.0, 0.1)
        image = np.array(image, dtype=np.float32, order="C")
        if flips:
            image = native.mirror3d(image, flips)
            if label is not None:
                label = native.mirror3d(
                    np.array(label, dtype=np.int32, order="C"), flips)
        image = native.add_gaussian_noise(
            image, float(scale), int(rs.randint(0, 2 ** 31)))
        return image, label

    def _parallel_samples(self, order, epoch: int) -> Iterator:
        """Fan sample assembly out over the thread pool, in order, with a
        bounded in-flight window (ThreadPoolExecutor.map would submit the
        whole epoch eagerly). Worker-count-independent streams: the sample
        at epoch position k draws from RandomState(PCG64([seed, epoch, k]))
        no matter which thread assembles it."""
        from collections import deque
        pool = self._executor()
        window = max(2 * self.num_workers, self.batch_size)

        def assemble(k: int, j: int):
            rs_j = np.random.RandomState(
                np.random.PCG64([self.seed, epoch, k]))
            return self._load_sample(self.samples[j], rs_j)

        pending: "deque" = deque()
        for k, j in enumerate(order):
            pending.append(pool.submit(assemble, int(k), int(j)))
            if len(pending) >= window:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()

    # -- epoch iteration ----------------------------------------------
    def _epoch_batches(self) -> Iterator[Dict]:
        epoch = self.num_restarted
        rs = np.random.RandomState(self.seed + epoch)
        order = np.arange(len(self.samples))
        if self.training:
            rs.shuffle(order)
        self.num_restarted += 1

        if self.num_workers >= 1:
            loaded = self._parallel_samples(order, epoch)
        else:
            loaded = (self._load_sample(self.samples[j], rs) for j in order)

        it = iter(loaded)
        for i in range(0, len(order),
                       self.batch_size):
            idx = order[i:i + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            data, segs, image_paths, label_paths, crops = [], [], [], [], []
            for j in idx:
                sample = self.samples[j]
                image, label, lp = next(it)
                data.append(image)
                segs.append(label)
                image_paths.append(sample["image_path"])
                label_paths.append(lp)
                if not self.training:
                    crops.append(sample["crop_idx"])
            batch = {
                "data": np.stack(data)[..., None],
                "image_paths": image_paths,
                "label_paths": label_paths,
            }
            if segs[0] is not None:
                batch["seg"] = np.stack(segs)
            if crops:
                batch["crop_idx"] = crops
            yield batch

    def __iter__(self) -> Iterator[Dict]:
        if self.prefetch <= 0:
            yield from self._epoch_batches()
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        error: List[BaseException] = []

        def worker():
            try:
                for batch in self._epoch_batches():
                    q.put(batch)
            except BaseException as e:  # propagate into the consumer
                error.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        t.join()
        if error:
            raise error[0]
