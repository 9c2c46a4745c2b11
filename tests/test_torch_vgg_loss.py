"""The port's ``VGG16Features`` and ``VGGFeatLoss`` against the JAX package's.

The JAX side initialises its VGG-16 column from ``jax.random.PRNGKey(0)``
(its loss's no-checkpoint form); ``interop.vgg16_state_dict_from_jax``
carries those parameters into the port. Images are numpy draws from a
seed at 32x32, where every tap (down to relu5_3 at 2x2) exists.
``from_torch`` reads a torchvision-keyed ``vgg16`` state dict that the test
builds from the same parameters and saves itself (classifier included).

Tolerances: f32 through thirteen convolutions in other sum orders; taps
within 1e-5 of their largest entry, the loss within 1e-5 relative, and the
column's gradient under a smooth objective (the taps' mean squares) within
1e-5 of its largest entry. The loss's own gradient is held at 2e-2 of its
largest entry: L1 has a kink at a = b, and where a tap's difference lies
within the packages' f32 rounding of 0 (about 2e-6 of the tap here) the
two take opposite signs there, which moves the gradient over that
element's receptive field by up to 2/N of the tap's gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributedtraining_tpu import losses as jlosses
from pytorch_distributedtraining_tpu.models.vgg import VGG16Features as JaxVGG
from pytorch_distributedtraining_tpu_torch import interop
from pytorch_distributedtraining_tpu_torch import losses as tlosses
from pytorch_distributedtraining_tpu_torch.models import SwinIR, VGG16Features
from pytorch_distributedtraining_tpu_torch.models import vgg as tvgg

TOL = 1e-5
CONVS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)  # torchvision's conv indices


@pytest.fixture(scope="module")
def jax_params():
    return jax.device_get(JaxVGG().init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"])


def _images(seed=1, batch=2, size=32):
    g = np.random.default_rng(seed)
    return (g.random((batch, size, size, 3)).astype(np.float32),
            g.random((batch, size, size, 3)).astype(np.float32))


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(1e-30, np.abs(want).max()))


def test_state_dict_is_torchvision_features():
    sd = VGG16Features().state_dict()
    assert set(sd) == {f"features.{i}.{leaf}" for i in CONVS for leaf in ("weight", "bias")}
    assert tuple(sd["features.28.weight"].shape) == (512, 512, 3, 3)


def test_taps_match_jax(jax_params):
    x, _ = _images()
    want = JaxVGG().apply({"params": jax_params}, jnp.asarray(x))
    net = VGG16Features()
    net.load_state_dict(interop.vgg16_state_dict_from_jax(jax_params), strict=True)
    got = net(torch.from_numpy(x))
    assert len(got) == len(want) == len(tvgg.RELU_TAPS)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape  # NHWC
        _close(g.detach().numpy(), w)


def test_column_gradient_matches_jax(jax_params):
    x, _ = _images(seed=2)

    def smooth(feats):
        return sum((f ** 2).mean() for f in feats)

    jg = jax.grad(lambda o: smooth(JaxVGG().apply({"params": jax_params}, o)))(jnp.asarray(x))
    net = VGG16Features()
    net.load_state_dict(interop.vgg16_state_dict_from_jax(jax_params), strict=True)
    o = torch.from_numpy(x).requires_grad_(True)
    smooth(net(o)).backward()
    _close(o.grad.numpy(), jg)


@pytest.mark.parametrize("feat_weight,pixel_weight", [(1.0, 1.0), (0.5, 0.0), (2.0, 0.1)])
def test_vgg_feat_loss_and_grad_match_jax(jax_params, feat_weight, pixel_weight):
    out, tgt = _images()
    jloss = jlosses.VGGFeatLoss(params=jax_params, feat_weight=feat_weight,
                                pixel_weight=pixel_weight)
    jl, jg = jax.value_and_grad(lambda o: jloss(o, jnp.asarray(tgt)))(jnp.asarray(out))
    tloss = tlosses.VGGFeatLoss(params=interop.vgg16_state_dict_from_jax(jax_params),
                                feat_weight=feat_weight, pixel_weight=pixel_weight,
                                device="cpu")
    o = torch.from_numpy(out).requires_grad_(True)
    tl = tloss(o, torch.from_numpy(tgt))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=TOL)
    _close(o.grad.numpy(), jg, tol=2e-2)


def _torchvision_file(tmp_path, jax_params, wrapper=None, drop=None):
    sd = {k: v for k, v in interop.vgg16_state_dict_from_jax(jax_params).items() if k != drop}
    g = torch.Generator().manual_seed(5)
    for i, (o, n) in zip((0, 3, 6), ((4096, 512 * 7 * 7), (4096, 4096), (1000, 4096))):
        # the classifier head of torchvision's vgg16, at a tenth of its rows
        sd[f"classifier.{i}.weight"] = torch.randn(o // 10, n // 10, generator=g)
        sd[f"classifier.{i}.bias"] = torch.zeros(o // 10)
    path = str(tmp_path / "vgg16-test.pth")
    torch.save(sd if wrapper is None else {wrapper: sd}, path)
    return path


@pytest.mark.parametrize("wrapper", [None, "state_dict"])
def test_from_torch_loads_a_torchvision_state_dict(tmp_path, jax_params, wrapper):
    path = _torchvision_file(tmp_path, jax_params, wrapper)
    tloss = tlosses.VGGFeatLoss.from_torch(path, device="cpu")
    out, tgt = _images(seed=3)
    want = jlosses.VGGFeatLoss(params=jax_params)(jnp.asarray(out), jnp.asarray(tgt))
    got = tloss(torch.from_numpy(out), torch.from_numpy(tgt))
    np.testing.assert_allclose(got.item(), float(want), rtol=TOL)


def test_from_torch_is_strict_on_the_conv_leaves(tmp_path, jax_params):
    path = _torchvision_file(tmp_path, jax_params, drop="features.14.weight")
    with pytest.raises(RuntimeError, match="features.14.weight"):
        tlosses.VGGFeatLoss.from_torch(path, device="cpu")


def test_default_init_is_seeded_with_the_jax_distribution():
    a = tlosses.VGGFeatLoss(device="cpu").net.state_dict()
    b = tlosses.VGGFeatLoss(device="cpu").net.state_dict()
    c = tlosses.VGGFeatLoss(seed=1, device="cpu").net.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["features.0.weight"], c["features.0.weight"])
    for i in CONVS:
        w = a[f"features.{i}.weight"]
        fan_in = w[0].numel()
        assert abs(w.std().item() * fan_in**0.5 - 1.0) < 0.1  # lecun: variance 1 / fan_in
        assert w.abs().max().item() <= 2 / 0.87962566103423978 / fan_in**0.5 + 1e-6
        assert not a[f"features.{i}.bias"].any()


def test_vgg_parameters_are_frozen_and_outside_the_optimizer():
    from pytorch_distributedtraining_tpu_torch import stoke as tstoke

    loss = tlosses.VGGFeatLoss(device="cpu")
    assert not any(p.requires_grad for p in loss.net.parameters())
    before = {k: v.clone() for k, v in loss.net.state_dict().items()}
    model = SwinIR(img_size=8, window_size=4, depths=(2,), embed_dim=12, num_heads=(2,),
                   upsampler="pixelshuffle", generator=torch.Generator().manual_seed(0))
    s = tstoke.Stoke(model=model, loss=loss, device="cpu", verbose=False,
                     optimizer=tstoke.StokeOptimizer(optimizer="AdamW",
                                                     optimizer_kwargs={"lr": 1e-3}))
    x, y = _images(seed=4, size=8)
    y = np.repeat(np.repeat(y, 2, axis=1), 2, axis=2)
    w0 = model.conv_first.weight.detach().clone()
    for _ in range(2):
        out = s.model(x)
        s.backward(s.loss(out, y))
        s.step()
    assert all(p.grad is None for p in loss.net.parameters())
    assert all(torch.equal(before[k], v) for k, v in loss.net.state_dict().items())
    assert not torch.equal(w0, model.conv_first.weight)
    n_model = sum(p.numel() for p in model.parameters())
    assert sum(p.numel() for p in s.model_access.parameters()) == n_model


def test_loss_refuses_cuda_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlosses.VGGFeatLoss()
