"""The port's super-resolution input path against the JAX package's.

``PatchStore``, ``PairedRandomAug``, the loader's epoch forwarding and the
host kernels of ``csrc.fastpipe`` are numpy and C++ on both sides, so they
are held to JAX's samples exactly: every array equal, element for element.
The patch store is written by ``np.save`` of seeded uint8 arrays (and once
by ``PatchStore.build`` from PNG folders). Loaders run on the CPU: the port's
with ``torch.utils.data`` worker processes (spawned, persistent), the JAX
package's with worker threads. ``device_iter`` on the CPU passes host
batches through, and must give plain iteration's batches in its order.
"""

import pickle

import numpy as np
import pytest
import torch

from pytorch_distributedtraining_tpu import csrc as jcsrc
from pytorch_distributedtraining_tpu.data.dataset import PatchStore as JaxPatchStore
from pytorch_distributedtraining_tpu.data.loader import DataLoader as JaxLoader
from pytorch_distributedtraining_tpu.data.transforms import PairedRandomAug as JaxAug
from pytorch_distributedtraining_tpu_torch import stoke as tstoke
from pytorch_distributedtraining_tpu_torch.csrc import fastpipe
from pytorch_distributedtraining_tpu_torch.data import (DataLoader, DevicePrefetcher,
                                                        PairedRandomAug, PatchStore)
from pytorch_distributedtraining_tpu_torch.losses import mse_loss
from pytorch_distributedtraining_tpu_torch.models import Net

N, LR = 16, 16  # patches in the store, LR side (HR is twice it)


def _write_store(path, n=N, lr=LR, seed=0):
    g = np.random.default_rng(seed)
    path.mkdir(parents=True, exist_ok=True)
    np.save(path / "lr.npy", g.integers(0, 256, (n, lr, lr, 3), dtype=np.uint8))
    np.save(path / "hr.npy", g.integers(0, 256, (n, 2 * lr, 2 * lr, 3), dtype=np.uint8))
    return str(path)


@pytest.fixture
def store(tmp_path):
    return _write_store(tmp_path / "store")


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for gb, wb in zip(got, want):
        assert len(gb) == len(wb)
        for g, w in zip(gb, wb):
            g = g.numpy() if isinstance(g, torch.Tensor) else g
            assert g.dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(g, np.asarray(w))


# -- fastpipe --------------------------------------------------------------------------


def test_fastpipe_builds_into_build_host():
    assert fastpipe.available()
    path = fastpipe.library_path()
    assert path.parent.name == "host" and path.parent.parent.name == "build"
    assert path.exists()
    assert fastpipe.load().fp_version() == 1


@pytest.mark.parametrize("dtype,shape,n", [(np.float32, (16, 16, 3), 4), (np.uint8, (32, 32, 3), 8),
                                           (np.float32, (4, 4, 3), 3), (np.float64, (40, 7), 5),
                                           (np.float32, (16, 16, 3), 1)])
def test_fast_stack_matches_numpy(dtype, shape, n):
    g = np.random.default_rng(0)
    arrays = [(g.random(shape) * 255).astype(dtype) for _ in range(n)]
    got = fastpipe.fast_stack(arrays, n_threads=3)
    np.testing.assert_array_equal(got, fastpipe.plain_stack(arrays))
    assert got.dtype == np.dtype(dtype) and got.shape == (n, *shape)


def test_fast_stack_refuses_mixed_shapes():
    with pytest.raises(ValueError, match="one shape"):
        fastpipe.fast_stack([np.zeros((32, 32, 3), np.float32), np.zeros((32, 31, 3), np.float32)])


@pytest.mark.parametrize("crop", [(8, 8), (16, 12)])
def test_fast_stack_strided_matches_numpy(crop):
    g = np.random.default_rng(1)
    images = [g.random((40, 40, 3)).astype(np.float32) for _ in range(6)]
    views = [im[3 + i: 3 + i + crop[0], 2: 2 + crop[1]] for i, im in enumerate(images)]
    assert not views[0].flags.c_contiguous
    np.testing.assert_array_equal(fastpipe.fast_stack_strided(views, n_threads=2),
                                  fastpipe.plain_stack(views))


@pytest.mark.parametrize("mean,std", [((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
                                      (0.0, 1.0), (0.5, 0.25)])
def test_normalize_u8_matches_numpy_and_jax(mean, std):
    batch = np.random.default_rng(2).integers(0, 256, (3, 33, 17, 3), dtype=np.uint8)
    got = fastpipe.normalize_u8(batch, mean=mean, std=std, n_threads=2)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, fastpipe.plain_normalize_u8(batch, mean=mean, std=std))
    assert jcsrc.available()  # the JAX package's library, built by its g++ path
    np.testing.assert_array_equal(got, jcsrc.normalize_u8(batch, mean=mean, std=std))


def test_normalize_u8_checks_channels():
    with pytest.raises(ValueError, match="channels"):
        fastpipe.normalize_u8(np.zeros((2, 2, 3), np.uint8), mean=(0.1, 0.2), std=(1.0, 1.0))


# -- PatchStore and PairedRandomAug ----------------------------------------------------------


@pytest.mark.parametrize("with_aug", [False, True])
def test_patch_store_samples_are_jax_samples(store, with_aug):
    tds = PatchStore(store, PairedRandomAug(scale=2, crop_lr=12) if with_aug else None)
    jds = JaxPatchStore(store, JaxAug(scale=2, crop_lr=12) if with_aug else None)
    assert len(tds) == len(jds) == N
    _assert_batches_equal([tds[i] for i in range(N)], [jds[i] for i in range(N)])
    lr, hr = tds[0]
    assert lr.dtype == np.float32 and 0.0 <= lr.min() and lr.max() <= 1.0
    assert hr.shape == ((24, 24, 3) if with_aug else (32, 32, 3))


def test_patch_store_build_matches_jax(tmp_path):
    from PIL import Image

    g = np.random.default_rng(3)
    for side in ("lr", "hr"):
        (tmp_path / side).mkdir()
    for i in range(4):
        hr = g.integers(0, 256, (16, 16, 3), dtype=np.uint8)
        lr = hr[::2, ::2]
        Image.fromarray(lr).save(tmp_path / "lr" / f"img{i}x2.png")
        Image.fromarray(hr).save(tmp_path / "hr" / f"img{i}.png")
    tds = PatchStore.build(str(tmp_path / "lr"), str(tmp_path / "hr"), str(tmp_path / "t"))
    jds = JaxPatchStore.build(str(tmp_path / "lr"), str(tmp_path / "hr"), str(tmp_path / "j"))
    for name in ("lr.npy", "hr.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / "t" / name),
                                      np.load(tmp_path / "j" / name))
    _assert_batches_equal([tds[i] for i in range(4)], [jds[i] for i in range(4)])


def test_patch_store_pickles_without_its_arrays(store):
    ds = PatchStore(store, PairedRandomAug(scale=2, crop_lr=8))
    blob = pickle.dumps(ds)
    assert len(blob) < 4096  # the memmaps reopen; 16 patches are ~60 KB
    back = pickle.loads(blob)
    _assert_batches_equal([back[i] for i in range(N)], [ds[i] for i in range(N)])


def test_patch_store_without_files_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="PatchStore.build"):
        PatchStore(str(tmp_path))


@pytest.mark.parametrize("kw", [dict(scale=2, crop_lr=8), dict(scale=2, crop_lr=None, vflip=True),
                                dict(scale=3, crop_lr=5, rot90=False, seed=7)])
def test_paired_random_aug_draws_are_jax_draws(kw):
    s = kw["scale"]
    g = np.random.default_rng(4)
    samples = [(g.random((10, 10, 3)).astype(np.float32),
                g.random((10 * s, 10 * s, 3)).astype(np.float32)) for _ in range(8)]
    taug, jaug = PairedRandomAug(**kw), JaxAug(**kw)
    seen = set()
    for epoch in range(3):
        taug.set_epoch(epoch)
        jaug.set_epoch(epoch)
        for idx, (lr, hr) in enumerate(samples):
            got, want = taug(lr, hr, idx), jaug(lr, hr, idx)
            _assert_batches_equal([got], [want])
            assert got[0].flags.c_contiguous and got[1].flags.c_contiguous
            seen.add(got[0].tobytes())
    assert len(seen) > 8  # the draws move with the epoch


def test_paired_random_aug_keeps_the_pair_aligned():
    hr = np.random.default_rng(5).random((32, 32, 3)).astype(np.float32)
    lr = hr.reshape(16, 2, 16, 2, 3).mean(axis=(1, 3))
    aug = PairedRandomAug(scale=2, crop_lr=8, vflip=True)
    for idx in range(6):
        a, b = aug(lr, hr, idx)
        np.testing.assert_allclose(b.reshape(8, 2, 8, 2, 3).mean(axis=(1, 3)), a, atol=1e-6)


# -- the loader: epoch forwarding and device prefetch ----------------------------------------


def _port_loader(store, workers, **kw):
    ds = PatchStore(store, PairedRandomAug(scale=2, crop_lr=8))
    return DataLoader(ds, batch_size=4, num_workers=workers, device="cpu",
                      persistent_workers=workers > 0,
                      multiprocessing_context="spawn" if workers else None, **kw)


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_forwards_the_epoch_to_the_transform(store, workers):
    """Epoch 1's crops are not epoch 0's, in worker processes that keep one
    pickled copy of the dataset across epochs, and each epoch's are JAX's."""
    loader = _port_loader(store, workers)
    jloader = JaxLoader(JaxPatchStore(store, JaxAug(scale=2, crop_lr=8)), batch_size=4,
                        num_workers=workers)
    try:
        epochs = [list(loader) for _ in range(2)]
        for got in epochs:
            _assert_batches_equal(got, list(jloader))
        assert not np.array_equal(epochs[0][0][0].numpy(), epochs[1][0][0].numpy())
        loader.set_epoch(5)
        jloader.set_epoch(5)
        _assert_batches_equal(list(loader), list(jloader))
    finally:
        loader.shutdown_workers()


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_device_iter_on_cpu_gives_plain_iterations_batches(store, depth):
    loader = _port_loader(store, 0)
    loader.set_epoch(2)
    plain = list(loader)
    loader.set_epoch(2)
    it = loader.device_iter(depth=depth)
    assert isinstance(it, DevicePrefetcher)
    assert it.overlap_fraction(1.0) is None
    staged = list(it)
    _assert_batches_equal(staged, plain)
    assert it.staged == it.yielded == len(plain) == N // 4
    assert 0.0 <= it.overlap_fraction(10.0) <= 1.0


def test_loader_with_device_prefetch_iterates_through_the_prefetcher(store):
    loader = _port_loader(store, 0, device_prefetch=2)
    it = iter(loader)
    assert isinstance(it, DevicePrefetcher) and it.depth == 2
    first = next(it)
    assert first[0].shape == (4, 8, 8, 3)
    it.close()
    assert list(it) == []
    assert loader.set_epoch(0) is None
    plain = _port_loader(store, 0)
    _assert_batches_equal(list(loader), list(plain))


@pytest.mark.parametrize("env,want", [(None, 2), ("0", 0), ("3", 3)])
def test_facade_loader_prefetches_as_the_jax_facade(monkeypatch, store, env, want):
    if env is None:
        monkeypatch.delenv("GRAFT_DEVICE_PREFETCH", raising=False)
    else:
        monkeypatch.setenv("GRAFT_DEVICE_PREFETCH", env)
    s = tstoke.Stoke(model=Net(), loss=mse_loss, device="cpu", verbose=False,
                     batch_size_per_device=4,
                     optimizer=tstoke.StokeOptimizer(optimizer="AdamW",
                                                     optimizer_kwargs={"lr": 1e-3}))
    loader = s.DataLoader(PatchStore(store))
    assert loader.device_prefetch == want
    assert s.DataLoader(PatchStore(store), device_prefetch=1).device_prefetch == 1
    batches = list(loader)
    assert len(batches) == N // 4 and batches[0][1].shape == (4, 32, 32, 3)
