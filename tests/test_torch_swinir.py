"""Port SwinIR vs the JAX SwinIR, from weights carried over by
``interop.swinir_state_dict_from_jax``.

A toy SwinIR (depths (2, 2), embed 12, 2 heads, window 4) at LR 8x8 runs
the forward and the gradient of every parameter through ``feat_loss`` on
both sides. The JAX model takes ``attn_impl='pallas'`` in interpret mode,
so the attention it runs is the TPU kernel the port's kernels replace.
LR 10x10 reflect-pads to 12x12, where the shift mask is computed instead of
read from the ``attn_mask`` buffer.

Tolerances: f32 on both sides with different sum orders; outputs agree to
~1e-6 and gradients to ~1e-5 relative, and the bounds leave a 10x margin.
Also here: the full-size key inventory against the official SwinIR-S file
(``official_inventory()``), the full-size carry-over strict-load, and the
numerical traps between flax and torch defaults.
"""

import importlib.util
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pytorch_distributedtraining_tpu import losses as jlosses
from pytorch_distributedtraining_tpu.models.sr_espcn import pixel_shuffle as jax_pixel_shuffle
from pytorch_distributedtraining_tpu.models.swinir import SwinIR as JaxSwinIR
from pytorch_distributedtraining_tpu_torch import losses as tlosses
from pytorch_distributedtraining_tpu_torch.interop import (
    espcn_state_dict_from_jax,
    swinir_state_dict_from_jax,
)
from pytorch_distributedtraining_tpu_torch.models import Net, SwinIR, pixel_shuffle
from pytorch_distributedtraining_tpu_torch.models.swinir import LN_EPS, Mlp

TOY = dict(upscale=2, in_chans=3, img_size=8, window_size=4, depths=(2, 2),
           embed_dim=12, num_heads=(2, 2), mlp_ratio=2.0)


def _official():
    path = Path(__file__).with_name("test_interop_swinir_official.py")
    spec = importlib.util.spec_from_file_location("_official_swinir", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _toy_pair(seed=0):
    jmodel = JaxSwinIR(**TOY, attn_impl="pallas")
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8, 8, 3)))["params"]
    params = jax.device_get(params)
    tmodel = SwinIR(**TOY)
    tmodel.load_state_dict(swinir_state_dict_from_jax(params, img_size=TOY["img_size"]))
    return jmodel, params, tmodel


@pytest.mark.parametrize("lr_size", [8, 10])
def test_toy_swinir_forward_and_grads_match_jax(lr_size):
    jmodel, params, tmodel = _toy_pair()
    r = np.random.default_rng(1)
    x = r.random((2, lr_size, lr_size, 3)).astype(np.float32)
    y = r.random((2, 2 * lr_size, 2 * lr_size, 3)).astype(np.float32)

    def jloss(p):
        out = jmodel.apply({"params": p}, jnp.asarray(x))
        return jlosses.FeatLoss()(out, jnp.asarray(y)), out

    (jl, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)

    tout = tmodel(torch.from_numpy(x))
    tl = tlosses.FeatLoss()(tout, torch.from_numpy(y))
    tl.backward()

    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    want = swinir_state_dict_from_jax(jax.device_get(jgrads), img_size=TOY["img_size"])
    named = dict(tmodel.named_parameters())
    assert set(named) <= set(want)
    for name, p in named.items():
        w = want[name].numpy()
        tol = 1e-4 * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(p.grad.numpy(), w, atol=tol, err_msg=name)


def test_full_size_state_dict_matches_official_inventory():
    inv = _official().official_inventory()
    sd = SwinIR().state_dict()
    assert set(sd) == set(inv)
    for k, shape in inv.items():
        assert tuple(sd[k].shape) == shape, k


def test_full_size_carry_over_strict_loads():
    mod = _official()
    _, params = mod._full_size_params()
    sd = swinir_state_dict_from_jax(jax.device_get(params))
    assert set(sd) == set(mod.official_inventory())
    model = SwinIR()
    model.load_state_dict(sd, strict=True)
    w = model.state_dict()["layers.3.residual_group.blocks.5.attn.qkv.weight"]
    src = params["rstb_3"]["layer_5"]["attn"]["qkv"]["kernel"]
    np.testing.assert_array_equal(w.numpy(), np.asarray(src).T)


def test_layernorm_epsilon_is_flax_default():
    """flax LayerNorm's epsilon is 1e-6, torch's default 1e-5: at a feature
    variance of 1e-6 the two differ by ~40%."""
    x = (np.random.default_rng(2).standard_normal((4, 12)) * 1e-3).astype(np.float32)
    want = fnn.LayerNorm().apply({"params": {"scale": jnp.ones(12), "bias": jnp.zeros(12)}},
                                 jnp.asarray(x))
    ln = SwinIR(**TOY).layers[0].residual_group.blocks[0].norm1
    assert ln.eps == LN_EPS == 1e-6
    got = ln(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
    loose = F.layer_norm(torch.from_numpy(x), (12,)).numpy()  # eps 1e-5
    assert np.abs(loose - np.asarray(want)).max() > 0.1


def test_mlp_gelu_is_tanh_approximate():
    x = np.linspace(-6, 6, 97, dtype=np.float32)
    want = np.asarray(fnn.gelu(jnp.asarray(x)))
    mlp = Mlp(1, 1)
    with torch.no_grad():
        mlp.fc1.weight.fill_(1.0), mlp.fc1.bias.zero_()
        mlp.fc2.weight.fill_(1.0), mlp.fc2.bias.zero_()
    got = mlp(torch.from_numpy(x)[:, None])[:, 0].detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    exact = F.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - want).max() > 1e-4


def test_pixel_shuffle_keeps_jax_channel_order():
    x = np.random.default_rng(3).standard_normal((2, 3, 5, 12)).astype(np.float32)
    want = np.asarray(jax_pixel_shuffle(jnp.asarray(x), 2))
    got = pixel_shuffle(torch.from_numpy(x), 2).numpy()
    np.testing.assert_array_equal(got, want)
    torch_order = F.pixel_shuffle(torch.from_numpy(x).permute(0, 3, 1, 2), 2)
    assert not np.allclose(torch_order.permute(0, 2, 3, 1).numpy(), want)


def test_espcn_net_matches_jax():
    from pytorch_distributedtraining_tpu.models.sr_espcn import Net as JaxNet

    x = np.random.default_rng(4).random((2, 9, 7, 3)).astype(np.float32)
    jnet = JaxNet(upscale_factor=2)
    params = jax.device_get(jnet.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    net = Net(upscale_factor=2)
    net.load_state_dict(espcn_state_dict_from_jax(params))
    want = np.asarray(jnet.apply({"params": params}, jnp.asarray(x)))
    got = net(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.slow
def test_full_size_swinir_forward_matches_jax():
    """SwinIR-S at full width and depth (24 Swin layers, embed 60, 6 heads,
    window 8) on one LR 16x16 image, from carried weights: the forward
    through the Pallas kernel (interpret mode) against the port's plain
    window attention. f32 both sides over 24 residual layers; ~1e-6
    relative observed, held at 1e-5."""
    jmodel = JaxSwinIR(attn_impl="pallas")
    x = np.random.default_rng(6).random((1, 16, 16, 3)).astype(np.float32)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    tmodel = SwinIR()
    tmodel.load_state_dict(swinir_state_dict_from_jax(params))
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
