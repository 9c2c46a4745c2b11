"""Paired SR augmentation: crop, flips and rot90 that keep LR and HR aligned.

Counterpart of ``pytorch_distributedtraining_tpu/data/transforms.py``, a
copy in numpy, so its draws are the JAX package's value for value:

- **pairing-preserving**: the HR window covers the LR window's content (HR
  coordinates = LR coordinates x scale), and flips and rotations act on
  both alike, so an exact ``scale x scale`` box-downsample relation between
  the pair survives augmentation;
- **deterministic**: draws are seeded by ``(seed, epoch, idx)`` through
  ``np.random.default_rng``, so an epoch's crops are the same on every rank
  and worker and after a resume. The loader forwards its epoch
  (``DataLoader.set_epoch`` and each iteration) to a transform that has
  ``set_epoch``, in worker processes too.

It works on host numpy HWC samples, in the input pipeline.
"""

from __future__ import annotations

import numpy as np


class PairedRandomAug:
    """Random paired crop + dihedral augmentation for (lr, hr) samples.

    Args:
        scale: HR/LR size ratio (the SR upscale factor).
        crop_lr: LR-space crop size; None keeps full size (no crop).
        hflip / vflip / rot90: enable the respective random transforms.
        seed: base seed for the per-``(epoch, idx)`` draws.

    Use as a dataset ``transform``::

        ds = CustomDataset(in_dir, tgt_dir,
                           transform=PairedRandomAug(scale=2, crop_lr=48))
        loader = DataLoader(ds, batch_size=16)  # forwards each epoch
    """

    def __init__(
        self,
        scale: int = 2,
        crop_lr: int | None = None,
        hflip: bool = True,
        vflip: bool = False,
        rot90: bool = True,
        seed: int = 0,
    ):
        self.scale = int(scale)
        if crop_lr is not None and int(crop_lr) < 1:
            # 0/negative would pass the per-call bounds check and emit
            # empty arrays that crash far away in collate or the model
            raise ValueError(f"crop_lr must be >= 1, got {crop_lr}")
        self.crop_lr = crop_lr
        self.hflip = hflip
        self.vflip = vflip
        self.rot90 = rot90
        self.seed = int(seed)
        self._epoch = 0
        self._warned_rot90 = False

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def __call__(self, lr: np.ndarray, hr: np.ndarray, idx: int = 0):
        s = self.scale
        if hr.shape[0] != lr.shape[0] * s or hr.shape[1] != lr.shape[1] * s:
            raise ValueError(
                f"hr {hr.shape[:2]} is not lr {lr.shape[:2]} x{s}"
            )
        rng = np.random.default_rng((self.seed, self._epoch, int(idx)))
        if self.crop_lr is not None:
            c = int(self.crop_lr)
            if c > min(lr.shape[0], lr.shape[1]):
                raise ValueError(
                    f"crop_lr={c} exceeds lr size {lr.shape[:2]}"
                )
            y = int(rng.integers(0, lr.shape[0] - c + 1))
            x = int(rng.integers(0, lr.shape[1] - c + 1))
            lr = lr[y : y + c, x : x + c]
            hr = hr[y * s : (y + c) * s, x * s : (x + c) * s]
        if self.hflip and rng.random() < 0.5:
            lr, hr = lr[:, ::-1], hr[:, ::-1]
        if self.vflip and rng.random() < 0.5:
            lr, hr = lr[::-1], hr[::-1]
        if self.rot90:
            if lr.shape[0] == lr.shape[1]:
                k = int(rng.integers(0, 4))
                if k:
                    lr = np.rot90(lr, k, axes=(0, 1))
                    hr = np.rot90(hr, k, axes=(0, 1))
            elif not self._warned_rot90:
                # silently-inert augmentation is worse than none: say so
                # once (raising would forbid flips-only use on full frames)
                import warnings

                self._warned_rot90 = True
                warnings.warn(
                    f"rot90 requested but sample is non-square "
                    f"{lr.shape[:2]} — rotation skipped (pass rot90=False "
                    "or crop_lr=<square size> to silence)",
                    RuntimeWarning,
                    stacklevel=2,
                )
        # contiguous copies: the collate's stack and the pinned host batch
        # want dense buffers, not reversed-stride views
        return np.ascontiguousarray(lr), np.ascontiguousarray(hr)
