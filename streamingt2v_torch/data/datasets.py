"""Datasets (counterpart of ``streamingt2v_tpu/data/datasets.py``): the
reference's single-image predict dataset, a folder of images, the
deterministic synthetic video clips that training tests use, and a
host-side batch iterator.  Host numpy, the same arrays as the JAX
package's; a batch goes to the device where the caller puts it."""

from __future__ import annotations

import glob
import os
from typing import Dict, Iterator, Sequence

import numpy as np


class SingleImageDataset:
    """The reference's predict dataset: yields {'image', 'sample_id'}."""

    def __init__(self, images: Sequence[np.ndarray]):
        self.images = list(images)

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return {"image": self.images[idx], "sample_id": np.asarray(idx)}


class ImageFolderDataset(SingleImageDataset):
    """A folder of images (or one image file) as a ``SingleImageDataset``."""

    EXTS = (".png", ".jpg", ".jpeg", ".webp", ".bmp")

    def __init__(self, path: str):
        from streamingt2v_torch.utils.media import load_image

        if os.path.isdir(path):
            files = sorted(f for f in glob.glob(os.path.join(path, "*"))
                           if f.lower().endswith(self.EXTS))
        else:
            files = [path]
        self.files = files
        super().__init__([load_image(f) for f in files])


class SyntheticVideoDataset:
    """Deterministic moving-gradient clips in [-1, 1], (frames, size, size,
    3) f32: no downloads, fully seeded."""

    def __init__(self, num_clips: int = 16, frames: int = 8, size: int = 32, seed: int = 0):
        self.num_clips = num_clips
        self.frames = frames
        self.size = size
        self.seed = seed

    def __len__(self) -> int:
        return self.num_clips

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(self.seed * 1000 + idx)
        xx, yy = np.meshgrid(np.linspace(-1, 1, self.size), np.linspace(-1, 1, self.size))
        vx, vy = rng.uniform(-0.1, 0.1, 2)
        phase = rng.uniform(0, np.pi)
        frames = [np.stack([np.sin(3 * (xx + vx * t) + phase),
                            np.cos(3 * (yy + vy * t)),
                            np.sin(2 * (xx + yy) + 0.3 * t)], axis=-1)
                  for t in range(self.frames)]
        return {"video": np.stack(frames).astype(np.float32), "sample_id": np.asarray(idx)}


def batch_iterator(dataset, batch_size: int, *, shuffle: bool = False, seed: int = 0,
                   drop_last: bool = True) -> Iterator[Dict[str, np.ndarray]]:
    """Collates dict samples into stacked batches, in order or shuffled from
    ``seed``; a last partial batch is dropped unless ``drop_last`` is false."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    for start in range(0, len(order), batch_size):
        idxs = order[start:start + batch_size]
        if drop_last and len(idxs) < batch_size:
            return
        samples = [dataset[int(i)] for i in idxs]
        yield {k: np.stack([s[k] for s in samples]) for k in samples[0]}
