"""Synthetic class-conditional images for the offline environment.

Numpy only, the JAX package's ``repro.data.images`` line for line (its
images and batches are bit-equal to the reference's).  Mirrors the LM
proxy-corpus methodology of ``repro.data.corpus``: the benchmarks run
without ImageNet, so the ViT benchmarks train and evaluate on a
deterministic generated dataset whose *structure* a small ViT must learn —
and whose decision margins quantization error can destroy.  Absolute top-1
numbers differ from the paper by construction; the tables assert the
ordering/closeness of methods, which transfers.

Each class owns a smooth multi-sinusoid template with a class-specific
channel mix.  A sample is its class template under a random cyclic shift and
contrast, plus dense Gaussian noise and *sparse high-magnitude outlier
pixels*.  The outliers matter: they inflate static (calibration-time)
activation ranges the way real ViT outlier tokens do, which is exactly the
failure mode that separates static-MSE from per-group dynamic ABFP scaling
in the paper's vision tables.
"""

from __future__ import annotations

import numpy as np


def synthetic_images(
    n: int,
    image_size: int = 32,
    n_channels: int = 3,
    n_classes: int = 10,
    seed: int = 0,
    noise: float = 1.8,
    outlier_frac: float = 0.002,
    outlier_scale: float = 20.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic (images (N,H,W,C) f32, labels (N,) i32) dataset.

    The default ``noise`` is tuned so a 60-step reduced-ViT proxy lands
    around 95-98% top-1 — high enough to train fast, low enough that 4-bit
    quantization error shows up as measurable accuracy movement instead of
    saturating at 100%.
    """
    rng = np.random.RandomState(seed)
    H = W = image_size
    ys, xs = np.meshgrid(
        np.arange(H, dtype=np.float64) / H,
        np.arange(W, dtype=np.float64) / W,
        indexing="ij",
    )
    templates = np.zeros((n_classes, H, W, n_channels))
    for c in range(n_classes):
        for _ in range(3):  # 3 sinusoid components per class
            fy, fx = rng.uniform(0.5, 3.0, size=2)
            phase = rng.uniform(0, 2 * np.pi)
            pattern = np.sin(2 * np.pi * (fy * ys + fx * xs) + phase)
            templates[c] += pattern[..., None] * rng.randn(n_channels)
        templates[c] /= max(templates[c].std(), 1e-6)

    # balanced labels in shuffled order (deterministic)
    labels = rng.permutation(np.arange(n) % n_classes).astype(np.int32)
    images = np.empty((n, H, W, n_channels), np.float32)
    for i in range(n):
        t = templates[labels[i]]
        t = np.roll(t, (rng.randint(H), rng.randint(W)), axis=(0, 1))
        contrast = 0.7 + 0.6 * rng.rand()
        img = contrast * t + noise * rng.randn(H, W, n_channels)
        k = max(int(outlier_frac * img.size), 1)
        flat = img.reshape(-1)
        idx = rng.randint(0, flat.size, size=k)
        flat[idx] += outlier_scale * rng.randn(k)
        images[i] = img.astype(np.float32)
    return images, labels


class ImageLoader:
    """Deterministic shuffled classification batches (pure function of step).

    Same resume contract as ``data.loader.LMLoader``: any step's batch is a
    pure function of (seed, step), so checkpointing the pipeline is
    checkpointing one integer.
    """

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 global_batch: int, seed: int = 0):
        assert len(images) == len(labels) and len(images) >= global_batch
        self.images = images
        self.labels = labels
        self.global_batch = global_batch
        self.seed = seed
        self.steps_per_epoch = max(len(images) // global_batch, 1)

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        epoch = step // self.steps_per_epoch
        within = step % self.steps_per_epoch
        perm = np.random.RandomState(self.seed + epoch).permutation(
            len(self.images)
        )
        rows = perm[within * self.global_batch:
                    (within + 1) * self.global_batch]
        return {"images": self.images[rows], "labels": self.labels[rows]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def eval_image_batches(images: np.ndarray, labels: np.ndarray, batch: int,
                       max_batches: int | None = None):
    """Sequential non-shuffled eval batches."""
    n_batches = len(images) // batch
    if max_batches is not None:
        n_batches = min(n_batches, max_batches)
    for b in range(n_batches):
        sl = slice(b * batch, (b + 1) * batch)
        yield {"images": images[sl], "labels": labels[sl]}
