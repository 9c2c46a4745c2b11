"""Datasets: paired-image SR data, patch stores, synthetic pairs, random_split.

Counterpart of ``pytorch_distributedtraining_tpu/data/dataset.py``; numpy
only (``PatchStore`` normalises through the host kernel of
``csrc.fastpipe``), so samples, splits and synthetic images are the JAX
package's, value for value. Samples are ``(lr, hr)`` NHWC-style
``(H, W, 3)`` float32 arrays in [0, 1].
"""

from __future__ import annotations

import os
import re
from typing import Sequence

import numpy as np

_IMG_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".webp", ".tif", ".tiff"}


class Dataset:
    """Minimal map-style dataset protocol (len + getitem)."""

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, idx: int):
        raise NotImplementedError


class Subset(Dataset):
    def __init__(self, dataset: Dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]


def random_split(dataset: Dataset, lengths: Sequence[int], seed: int = 0):
    """Seeded permutation, contiguous cuts (``torch.utils.data.random_split``
    semantics with the JAX package's numpy permutation)."""
    if sum(lengths) != len(dataset):
        raise ValueError(f"lengths {lengths} must sum to dataset size {len(dataset)}")
    perm = np.random.default_rng(seed).permutation(len(dataset))
    out, ofs = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[ofs : ofs + n].tolist()))
        ofs += n
    return out


def _load_image(path: str) -> np.ndarray:
    """Decode to (H, W, 3) float32 in [0, 1], tolerating truncated files."""
    from PIL import Image, ImageFile

    ImageFile.LOAD_TRUNCATED_IMAGES = True
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0


def _stem(path: str) -> str:
    """Basename without extension or a trailing LR scale suffix (x2/x3/x4...)."""
    return re.sub(r"x\d+$", "", os.path.splitext(os.path.basename(path))[0])


def _list_images(root: str) -> list[str]:
    files = [
        os.path.join(root, f)
        for f in sorted(os.listdir(root))
        if os.path.splitext(f)[1].lower() in _IMG_EXTS
    ]
    if not files:
        raise FileNotFoundError(f"no images under {root}")
    return files


class CustomDataset(Dataset):
    """Paired LR/HR image-folder dataset, paired by sorted filename."""

    def __init__(self, input_path: str, target_path: str, transform=None):
        self.transform = transform
        self.input_files = _list_images(input_path)
        self.target_files = _list_images(target_path)
        if len(self.input_files) != len(self.target_files):
            raise ValueError(
                f"input/target counts differ: {len(self.input_files)} vs "
                f"{len(self.target_files)}"
            )
        for a, b in zip(self.input_files, self.target_files):
            if _stem(a) != _stem(b):
                raise ValueError(
                    f"input/target filenames do not pair up: {os.path.basename(a)} vs "
                    f"{os.path.basename(b)} (stems {_stem(a)!r} != {_stem(b)!r})"
                )

    def __len__(self):
        return len(self.input_files)

    def __getitem__(self, idx):
        lr = _load_image(self.input_files[idx])
        hr = _load_image(self.target_files[idx])
        if self.transform is not None:
            lr, hr = self.transform(lr, hr, idx)
        return lr, hr


class PatchStore(Dataset):
    """Decode-free paired dataset over pre-extracted ``.npy`` patch stores.

    ``PatchStore.build`` decodes an image-folder pair once into uint8
    ``lr.npy``/``hr.npy`` arrays; training then reads patches through
    read-only memmaps (no page-in of the whole store) and normalises them
    to f32 in [0, 1] with ``csrc.fastpipe.normalize_u8``. Samples come out
    ``(lr_HWC, hr_HWC)`` as from :class:`CustomDataset`, through
    ``transform`` (e.g. ``transforms.PairedRandomAug``) when one is set.
    A pickled store (a loader's worker process) reopens its memmaps
    rather than carrying the arrays.
    """

    LR_NAME, HR_NAME = "lr.npy", "hr.npy"

    def __init__(self, store_dir: str, transform=None):
        self.transform = transform
        self.store_dir = store_dir
        lr_path = os.path.join(store_dir, self.LR_NAME)
        hr_path = os.path.join(store_dir, self.HR_NAME)
        if not (os.path.exists(lr_path) and os.path.exists(hr_path)):
            raise FileNotFoundError(
                f"no patch store under {store_dir}: create one with "
                "PatchStore.build(input_path, target_path, store_dir)"
            )
        self._open()

    def _open(self) -> None:
        self._lr = np.load(os.path.join(self.store_dir, self.LR_NAME), mmap_mode="r")
        self._hr = np.load(os.path.join(self.store_dir, self.HR_NAME), mmap_mode="r")
        if len(self._lr) != len(self._hr):
            raise ValueError(f"corrupt store: {len(self._lr)} lr vs {len(self._hr)} hr")

    def __getstate__(self):
        state = dict(self.__dict__)
        del state["_lr"], state["_hr"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._open()

    @classmethod
    def build(cls, input_path: str, target_path: str, store_dir: str) -> "PatchStore":
        """One-time extraction: decode a :class:`CustomDataset` image-folder
        pair into uint8 ``.npy`` stores (all patches must share a shape),
        written straight to disk-backed arrays."""
        src = CustomDataset(input_path, target_path)
        os.makedirs(store_dir, exist_ok=True)
        lr0, hr0 = src[0]
        lr = np.lib.format.open_memmap(os.path.join(store_dir, cls.LR_NAME), mode="w+",
                                       shape=(len(src), *lr0.shape), dtype=np.uint8)
        hr = np.lib.format.open_memmap(os.path.join(store_dir, cls.HR_NAME), mode="w+",
                                       shape=(len(src), *hr0.shape), dtype=np.uint8)
        for i in range(len(src)):
            a, b = src[i]
            if a.shape != lr0.shape or b.shape != hr0.shape:
                raise ValueError(
                    f"patch {i} shape {a.shape}/{b.shape} differs from "
                    f"{lr0.shape}/{hr0.shape}; PatchStore needs uniform patches (pre-crop first)"
                )
            lr[i] = np.round(a * 255.0)
            hr[i] = np.round(b * 255.0)
        lr.flush()
        hr.flush()
        del lr, hr
        return cls(store_dir)

    def __len__(self):
        return len(self._lr)

    def __getitem__(self, idx):
        from ..csrc import fastpipe

        # one thread: the loader's workers already spread samples over cores
        lr = fastpipe.normalize_u8(np.asarray(self._lr[idx]), mean=0.0, std=1.0, n_threads=1)
        hr = fastpipe.normalize_u8(np.asarray(self._hr[idx]), mean=0.0, std=1.0, n_threads=1)
        if self.transform is not None:
            lr, hr = self.transform(lr, hr, idx)
        return lr, hr


class SyntheticSRDataset(Dataset):
    """Deterministic synthetic LR/HR pairs: smooth random HR imagery and its
    exact ``scale x scale`` box downsample as LR."""

    def __init__(self, n: int = 64, lr_size: int = 16, scale: int = 2, seed: int = 0):
        self.n, self.lr_size, self.scale, self.seed = n, lr_size, scale, seed

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        if not 0 <= idx < self.n:
            raise IndexError(idx)
        rng = np.random.default_rng(self.seed * 100003 + idx)
        hs = self.lr_size * self.scale
        coarse = rng.random((self.lr_size // 2 + 1, self.lr_size // 2 + 1, 3))
        hr = _bilinear_resize(coarse.astype(np.float32), hs, hs)
        lr = hr.reshape(self.lr_size, self.scale, self.lr_size, self.scale, 3).mean(axis=(1, 3))
        return lr.astype(np.float32), hr.astype(np.float32)


def _bilinear_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    h, w, _ = img.shape
    ys = np.linspace(0, h - 1, out_h)
    xs = np.linspace(0, w - 1, out_w)
    y0 = np.clip(ys.astype(int), 0, h - 2)
    x0 = np.clip(xs.astype(int), 0, w - 2)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    a = img[y0][:, x0]
    b = img[y0][:, x0 + 1]
    c = img[y0 + 1][:, x0]
    d = img[y0 + 1][:, x0 + 1]
    return a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx + c * wy * (1 - wx) + d * wy * wx
