"""Deterministic synthetic datasets with real learnable signal.

The faithful repro cannot ship CIFAR-100/ImageNet bits, so we generate
class-structured data whose difficulty is controlled: images are per-class
low-frequency templates + noise (so small models separate them after a few
epochs, and *resolution carries information* — downsampled images are
genuinely easier/coarser, matching the paper's progressive-resolution
premise), and LM tokens follow a class-dependent Markov chain.

Both datasets speak the ``DataPlane`` source contract
(``repro_torch.data.plane``):

    len(source)                       virtual dataset size
    source.batch_at(indices, size)    indexed, deterministic batch at the
                                      phase's input size (images resize,
                                      token walks crop to a prefix)
    source.struct(batch, size)        {key: (shape, dtype)} without
                                      materializing data (warm-compile)

``SyntheticTokens.batch_at`` is *prefix-stable*: example ``i`` at seq 64 is
the literal prefix of example ``i`` at seq 128 (class, start token and the
uniform draws are consumed in a fixed order), so cyclic seq-len schedules
train on consistent streams across sub-stages.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.pipeline import bilinear_resize, resize_images


class SyntheticImages:
    """CIFAR-like: (N, r, r, 3) float images in [0,1], C classes."""

    def __init__(self, *, n_train: int = 2048, n_test: int = 512,
                 num_classes: int = 10, base_res: int = 32,
                 noise: float = 0.35, seed: int = 0):
        rng = np.random.RandomState(seed)
        self.num_classes = num_classes
        self.base_res = base_res
        # low-frequency class templates: random 4x4 upsampled to base_res
        low = rng.randn(num_classes, 4, 4, 3).astype(np.float32)
        self.templates = np.stack([
            bilinear_resize(low[c], base_res) for c in range(num_classes)])
        self.noise = noise
        self._rng = rng
        self.train_labels = rng.randint(0, num_classes, size=n_train)
        self.test_labels = rng.randint(0, num_classes, size=n_test)
        self.train_noise = rng.randn(n_train, base_res, base_res, 3) \
            .astype(np.float32)
        self.test_noise = rng.randn(n_test, base_res, base_res, 3) \
            .astype(np.float32)

    def _images(self, labels, noise_bank, resolution: int):
        imgs = self.templates[labels] + self.noise * noise_bank
        return resize_images(imgs, resolution)

    def train_batch(self, idx, resolution: int):
        idx = np.asarray(idx)
        return {"images": self._images(self.train_labels[idx],
                                       self.train_noise[idx], resolution),
                "labels": self.train_labels[idx].astype(np.int32)}

    def test_set(self, resolution: int):
        n = len(self.test_labels)
        return {"images": self._images(self.test_labels,
                                       self.test_noise, resolution),
                "labels": self.test_labels.astype(np.int32)}

    def __len__(self):
        return len(self.train_labels)

    # -- DataPlane source contract --------------------------------------
    def batch_at(self, indices, input_size: int):
        return self.train_batch(indices, input_size)

    def struct(self, batch: int, input_size: int):
        return {"images": ((batch, input_size, input_size, 3), np.float32),
                "labels": ((batch,), np.int32)}


class SyntheticTokens:
    """LM data: per-sequence latent class selects a Markov transition matrix,
    so next-token prediction is learnable (entropy << uniform).

    ``n_examples`` bounds the indexed (``batch_at``) view — example ``i`` is
    a deterministic walk seeded from ``(seed, i)``, generated lazily and
    prefix-stable across sequence lengths.
    """

    def __init__(self, *, vocab: int = 256, num_classes: int = 8,
                 concentration: float = 0.05, seed: int = 0,
                 n_examples: int = 4096):
        rng = np.random.RandomState(seed)
        self.vocab = vocab
        mats = rng.dirichlet(np.full(vocab, concentration),
                             size=(num_classes, vocab)).astype(np.float64)
        self.trans = mats / mats.sum(-1, keepdims=True)
        self.num_classes = num_classes
        self.n_examples = int(n_examples)
        self.seed = seed
        self._cum = np.cumsum(self.trans, axis=-1)

    def batch(self, rng: np.random.RandomState, batch: int, seq: int):
        """Legacy rng-driven sampling (stream depends on the caller's rng
        state); prefer ``batch_at`` for order-independent determinism."""
        toks = np.zeros((batch, seq + 1), np.int32)
        cls = rng.randint(0, self.num_classes, size=batch)
        toks[:, 0] = rng.randint(0, self.vocab, size=batch)
        for t in range(seq):
            for b in range(batch):
                p = self.trans[cls[b], toks[b, t]]
                toks[b, t + 1] = rng.choice(self.vocab, p=p)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def _walk(self, idx: int, seq: int) -> np.ndarray:
        """Deterministic (seq+1,) walk for example ``idx``.  Class, start
        token and the per-step uniforms are consumed in a fixed order, so
        ``_walk(i, s)`` is a prefix of ``_walk(i, s')`` for s < s'."""
        rng = np.random.RandomState(
            (1_000_003 * self.seed + 7919 * int(idx) + 13) % 2**32)
        cls = rng.randint(self.num_classes)
        toks = np.empty(seq + 1, np.int32)
        toks[0] = rng.randint(self.vocab)
        us = rng.random_sample(seq)
        cum = self._cum[cls]
        for t in range(seq):
            toks[t + 1] = min(int(np.searchsorted(cum[toks[t]], us[t],
                                                  side="right")),
                              self.vocab - 1)
        return toks

    def __len__(self):
        return self.n_examples

    # -- DataPlane source contract --------------------------------------
    def batch_at(self, indices, input_size: int):
        # each walk is generated AT the requested length — prefix-stability
        # lives in _walk's fixed draw order, not in a post-hoc crop
        toks = np.stack([self._walk(i, input_size)
                         for i in np.asarray(indices)])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def struct(self, batch: int, input_size: int):
        return {"tokens": ((batch, input_size), np.int32),
                "labels": ((batch, input_size), np.int32)}
