"""The port's SwinIR tails and options against the JAX SwinIR.

Weights come from the JAX model's init and are carried over by
``interop.swinir_state_dict_from_jax``; inputs and targets are numpy draws
from a seed. A toy body (depths (2, 2), embed 12, 2 heads, window 4) at LR
8x8 runs under an MSE against a random target, so the gradient reaches
every parameter of the tail.

- Tails: classical ``'pixelshuffle'`` at x2, x3 and x4 and real-SR
  ``'nearest+conv'`` at x2 and x4, forward and gradients.
- Options: each ``attn_impl`` (the JAX side runs the same choice; its
  ``'pallas'`` in interpret mode), ``attn_pack=2`` against pack 1 (the
  port's kernels run one window a tile whatever the choice: JAX's packed
  layouts at even and odd window counts give the port's output),
  ``norm_dtype=bfloat16``, the ``softmax_dtype`` error, and ``remat``
  full / dots / offload against none.
- Loading: a JAX ``scan_layers=True`` checkpoint, and official-layout
  ``.pth`` files of the three tails through the facade.

Tolerances: f32 on both sides with different sum orders. Outputs within
1e-5 relative to the largest entry, gradients within 1e-4 relative to each
parameter's largest entry. ``norm_dtype=bfloat16`` rounds four LayerNorm
outputs to bf16 on both sides, where a value that lands on a rounding
boundary in one package may round the other way in the other (one bf16
step, 2^-8 relative): held at 1e-2. Remat against none in the port is the
same arithmetic recomputed: 1e-6.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributedtraining_tpu.models import swinir as jswinir
from pytorch_distributedtraining_tpu.models.swinir import SwinIR as JaxSwinIR
from pytorch_distributedtraining_tpu_torch import interop
from pytorch_distributedtraining_tpu_torch import losses as tlosses
from pytorch_distributedtraining_tpu_torch.drivers import stoke_ddp
from pytorch_distributedtraining_tpu_torch.models import SwinIR
from pytorch_distributedtraining_tpu_torch.models import scan_utils
from pytorch_distributedtraining_tpu_torch.models import swinir as tswinir
from pytorch_distributedtraining_tpu_torch.ops import window_attn

BODY = dict(in_chans=3, img_size=8, window_size=4, depths=(2, 2), embed_dim=12,
            num_heads=(2, 2), mlp_ratio=2.0)
OUT_TOL, GRAD_TOL = 1e-5, 1e-4


def _pair(lr: int = 8, seed: int = 0, **kw):
    """A JAX SwinIR and the port's with its weights; ``kw`` goes to both
    (torch dtypes are given as ``jax_kw``/``torch_kw`` entries)."""
    jax_kw = kw.pop("jax_kw", {})
    torch_kw = kw.pop("torch_kw", {})
    jmodel = JaxSwinIR(**BODY, **kw, **jax_kw)
    params = jax.device_get(
        jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, lr, lr, 3)))["params"])
    tmodel = SwinIR(**BODY, **kw, **torch_kw)
    tmodel.load_state_dict(interop.swinir_state_dict_from_jax(params, img_size=BODY["img_size"]))
    return jmodel, params, tmodel


def _data(lr: int, r: int, batch: int = 2, seed: int = 1):
    g = np.random.default_rng(seed)
    x = g.random((batch, lr, lr, 3)).astype(np.float32)
    y = g.random((batch, r * lr, r * lr, 3)).astype(np.float32)
    return x, y


def _jax_run(jmodel, params, x, y):
    def loss(p):
        out = jmodel.apply({"params": p}, jnp.asarray(x))
        return jnp.mean((out - jnp.asarray(y)) ** 2), out

    (jl, jout), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return float(jl), np.asarray(jout), jax.device_get(jgrads)


def _torch_run(tmodel, x, y):
    tmodel.zero_grad()
    out = tmodel(torch.from_numpy(x))
    loss = tlosses.mse_loss(out, torch.from_numpy(y))
    loss.backward()
    return loss.item(), out.detach().numpy(), {n: p.grad.clone() for n, p in
                                               tmodel.named_parameters()}


def _assert_out(got, want, tol=OUT_TOL):
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, np.abs(want).max()))


def _assert_grads(tgrads, jgrads, tol=GRAD_TOL):
    want = interop.swinir_state_dict_from_jax(jgrads, img_size=BODY["img_size"])
    assert set(tgrads) <= set(want)
    for name, g in tgrads.items():
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=tol * max(1e-30, np.abs(w).max()), err_msg=name)


def _match_jax(lr=8, r=2, **kw):
    jmodel, params, tmodel = _pair(lr=lr, upscale=r, **kw)
    x, y = _data(lr, r)
    jl, jout, jgrads = _jax_run(jmodel, params, x, y)
    tl, tout, tgrads = _torch_run(tmodel, x, y)
    assert tout.shape == jout.shape == (2, r * lr, r * lr, 3)
    _assert_out(tout, jout)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _assert_grads(tgrads, jgrads)
    return tmodel


# -- tails ----------------------------------------------------------------------


@pytest.mark.parametrize("upsampler,r", [("pixelshuffle", 2), ("pixelshuffle", 3),
                                         ("pixelshuffle", 4), ("nearest+conv", 2),
                                         ("nearest+conv", 4)])
def test_tail_forward_and_grads_match_jax(upsampler, r):
    _match_jax(r=r, upsampler=upsampler)


TAIL_KEYS = {
    ("pixelshuffle", 2): ["conv_before_upsample.0", "upsample.0", "conv_last"],
    ("pixelshuffle", 3): ["conv_before_upsample.0", "upsample.0", "conv_last"],
    ("pixelshuffle", 4): ["conv_before_upsample.0", "upsample.0", "upsample.2", "conv_last"],
    ("nearest+conv", 2): ["conv_before_upsample.0", "conv_up1", "conv_hr", "conv_last"],
    ("nearest+conv", 4): ["conv_before_upsample.0", "conv_up1", "conv_up2", "conv_hr",
                          "conv_last"],
    ("pixelshuffledirect", 2): ["upsample.0"],
}


@pytest.mark.parametrize("upsampler,r", sorted(TAIL_KEYS))
def test_tail_names_follow_official_swinir(upsampler, r):
    """The tail's parameters carry official torch-SwinIR's names, so an
    official file of the family strict-loads."""
    sd = SwinIR(**BODY, upscale=r, upsampler=upsampler).state_dict()
    tail = sorted(k for k in sd if not re.match(
        r"(layers\.|conv_first|patch_embed|norm\.|conv_after_body)", k))
    assert tail == sorted(f"{m}.{leaf}" for m in TAIL_KEYS[upsampler, r]
                          for leaf in ("weight", "bias"))
    if upsampler == "pixelshuffle":
        assert sd["upsample.0.weight"].shape[0] == (9 if r == 3 else 4) * tswinir.NUM_FEAT


def test_pixel_shuffle_tails_keep_jax_channel_order():
    """The classical tail shuffles in the JAX order, not F.pixel_shuffle's:
    with weights from JAX the two differ at the tail and nowhere else."""
    jmodel, params, tmodel = _pair(upscale=2, upsampler="pixelshuffle")
    x, _ = _data(8, 2)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    _assert_out(tmodel(torch.from_numpy(x)).detach().numpy(), want)
    shuffle = tmodel.upsample[1]

    def torch_order(t):  # NHWC through F.pixel_shuffle's channel order
        return torch.nn.functional.pixel_shuffle(t.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)

    shuffle.forward = torch_order
    wrong = tmodel(torch.from_numpy(x)).detach().numpy()
    assert np.abs(wrong - want).max() > 1e-3


@pytest.mark.parametrize("upsampler,r", [("pixelshuffle", 5), ("nearest+conv", 3),
                                         ("unknown", 2)])
def test_unsupported_tails_raise_as_jax(upsampler, r):
    with pytest.raises(NotImplementedError):
        SwinIR(**BODY, upscale=r, upsampler=upsampler)
    with pytest.raises(NotImplementedError):
        JaxSwinIR(**BODY, upscale=r, upsampler=upsampler).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)))


def test_resi_connection_other_than_1conv_raises():
    """The JAX SwinIR builds the 1-conv residual whatever the field says;
    the port takes nothing it cannot build."""
    with pytest.raises(NotImplementedError, match="1-conv"):
        SwinIR(**BODY, resi_connection="3conv")


# -- options ----------------------------------------------------------------------


@pytest.mark.parametrize("attn_impl", ["xla", "pallas", "paired", "blockdiag"])
def test_attn_impl_matches_jax(attn_impl):
    _match_jax(upsampler="pixelshuffle", attn_impl=attn_impl)


def test_attn_pack_2_matches_jax_and_pack_1():
    packed = _match_jax(upsampler="pixelshuffle", attn_impl="pallas", attn_pack=2)
    x, y = _data(8, 2)
    _, out2, g2 = _torch_run(packed, x, y)
    plain = SwinIR(**BODY, upsampler="pixelshuffle", attn_impl="pallas", attn_pack=1)
    plain.load_state_dict(packed.state_dict())
    _, out1, g1 = _torch_run(plain, x, y)
    _assert_out(out2, out1)
    for name in g1:
        np.testing.assert_allclose(g2[name].numpy(), g1[name].numpy(), rtol=0,
                                   atol=GRAD_TOL * max(1e-30, g1[name].abs().max().item()))


@pytest.mark.parametrize("attn_impl,attn_pack", [("paired", 1), ("pallas", 2)])
@pytest.mark.parametrize("lr,batch,want", [
    (12, 1, {(9, None), (9, 9)}),  # 9 windows: JAX falls back to pack 1
    (12, 2, {(18, None), (18, 9)}),  # JAX packs the unmasked layers only
    (8, 2, {(8, None), (8, 4)}),  # JAX packs every layer
])
def test_odd_window_counts_fall_back_to_pack_1(monkeypatch, attn_impl, attn_pack, lr, batch,
                                                want):
    """The JAX model packs two windows a tile where the window count and
    the mask's divide by 2 and falls back to pack 1 elsewhere; the port
    runs every layer at pack 1 (q of ``ws*ws`` tokens), and its output is
    JAX's either way."""
    seen = set()
    plain = window_attn.window_attention

    def spy(q, k, v, bias, mask=None):
        assert q.shape[2] == 16  # one 4x4 window a tile
        seen.add((q.shape[0], None if mask is None else mask.shape[0]))
        return plain(q, k, v, bias, mask)

    monkeypatch.setattr(window_attn, "window_attention", spy)
    jmodel, params, tmodel = _pair(lr=lr, upsampler="pixelshuffle", attn_impl=attn_impl,
                                   attn_pack=attn_pack)
    x, _ = _data(lr, 2, batch=batch)
    want_out = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    _assert_out(tmodel(torch.from_numpy(x)).detach().numpy(), want_out)
    assert seen == want


def test_norm_dtype_bfloat16_matches_jax():
    jmodel, params, tmodel = _pair(upscale=2, upsampler="pixelshuffle",
                                   jax_kw=dict(norm_dtype=jnp.bfloat16),
                                   torch_kw=dict(norm_dtype=torch.bfloat16))
    x, y = _data(8, 2)
    jl, jout, jgrads = _jax_run(jmodel, params, x, y)
    tl, tout, tgrads = _torch_run(tmodel, x, y)
    assert tout.dtype == np.float32
    _assert_out(tout, jout, tol=1e-2)
    _assert_grads(tgrads, jgrads, tol=1e-2)
    # and the rounding is there: f32 norms give another output
    f32 = SwinIR(**BODY, upsampler="pixelshuffle")
    f32.load_state_dict(tmodel.state_dict())
    assert np.abs(f32(torch.from_numpy(x)).detach().numpy() - tout).max() > 1e-6


def test_softmax_dtype_other_than_f32_raises():
    with pytest.raises(ValueError, match="softmax"):
        SwinIR(**BODY, softmax_dtype=torch.bfloat16)
    jmodel = JaxSwinIR(**BODY, attn_impl="pallas", softmax_dtype=jnp.bfloat16)
    with pytest.raises(ValueError, match="softmax"):
        jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)))


def test_unknown_attn_impl_raises_as_jax():
    with pytest.raises(ValueError, match="attn_impl"):
        SwinIR(**BODY, attn_impl="flash")
    with pytest.raises(ValueError, match="attn_impl"):
        JaxSwinIR(**BODY, attn_impl="flash").init(jax.random.PRNGKey(0),
                                                  jnp.zeros((1, 8, 8, 3)))


@pytest.mark.parametrize("remat", ["full", "dots", "offload"])
def test_remat_matches_no_remat_and_jax(remat):
    jmodel, params, tmodel = _pair(upscale=2, upsampler="pixelshuffle",
                                   jax_kw=dict(remat="full" if remat == "offload" else remat),
                                   torch_kw=dict(remat=remat))
    assert tmodel.remat == remat
    x, y = _data(8, 2)
    jl, jout, jgrads = _jax_run(jmodel, params, x, y)
    tl, tout, tgrads = _torch_run(tmodel, x, y)
    _assert_out(tout, jout)
    _assert_grads(tgrads, jgrads)
    plain = SwinIR(**BODY, upsampler="pixelshuffle")
    plain.load_state_dict(tmodel.state_dict())
    pl, pout, pgrads = _torch_run(plain, x, y)
    _assert_out(tout, pout, tol=1e-6)
    for name in pgrads:
        np.testing.assert_allclose(tgrads[name].numpy(), pgrads[name].numpy(), rtol=0,
                                   atol=1e-6 * max(1e-30, pgrads[name].abs().max().item()))


def test_remat_names_raises():
    with pytest.raises(NotImplementedError, match="names"):
        SwinIR(**BODY, remat="names")
    with pytest.raises(ValueError, match="remat"):
        SwinIR(**BODY, remat="sometimes")


def test_driver_remat_flag_reaches_every_swin_layer(monkeypatch):
    opt = stoke_ddp.build_parser().parse_args(["--remat", "full"])
    assert opt.remat == "full"
    model = stoke_ddp.build_model(remat=opt.remat)
    assert model.remat == "full"
    assert {rstb.residual_group.remat for rstb in model.layers} == {"full"}
    assert stoke_ddp.build_parser().parse_args([]).remat is None


# -- loading --------------------------------------------------------------------------


def test_scan_layers_checkpoint_loads_into_the_port():
    """A JAX ``scan_layers=True`` model's params (stacked W-MSA/SW-MSA pairs)
    carry over as they are and give the scanned model's output."""
    kw = dict(upscale=2, upsampler="pixelshuffle")
    jscan = JaxSwinIR(**BODY, **kw, scan_layers=True)
    params = jax.device_get(jscan.init(jax.random.PRNGKey(3), jnp.zeros((1, 8, 8, 3)))["params"])
    assert "layers" in params["rstb_0"]
    tmodel = SwinIR(**BODY, **kw)
    tmodel.load_state_dict(interop.swinir_state_dict_from_jax(params, img_size=8), strict=True)
    x, _ = _data(8, 2)
    want = np.asarray(jscan.apply({"params": params}, jnp.asarray(x)))
    _assert_out(tmodel(torch.from_numpy(x)).detach().numpy(), want)


def test_scan_layout_converters_match_jax():
    params = jax.device_get(JaxSwinIR(**BODY).init(jax.random.PRNGKey(4),
                                                   jnp.zeros((1, 8, 8, 3)))["params"])
    got = scan_utils.stack_swinir_layer_params(params, BODY["depths"])
    want = jax.device_get(jswinir.stack_swinir_layer_params(params, BODY["depths"]))
    flat_got, flat_want = interop._flatten(got), interop._flatten(want)
    assert set(flat_got) == set(flat_want)
    for k in flat_want:
        np.testing.assert_array_equal(flat_got[k], flat_want[k])
    back = interop._flatten(scan_utils.unstack_swinir_layer_params(got))
    flat = interop._flatten(params)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])


@pytest.mark.parametrize("upsampler,r", [("pixelshuffledirect", 2), ("pixelshuffle", 2),
                                         ("nearest+conv", 4)])
def test_official_pth_loads_through_the_facade(tmp_path, upsampler, r):
    """An official-layout file (``{'params': state_dict}``, the buffers
    included) of each tail loads strictly through ``load_model_state``."""
    from pytorch_distributedtraining_tpu_torch import stoke as tstoke

    jmodel, params, src = _pair(upscale=r, upsampler=upsampler)
    path = str(tmp_path / f"{upsampler}_x{r}.pth")
    torch.save({"params": src.state_dict()}, path)
    s = tstoke.Stoke(model=SwinIR(**BODY, upscale=r, upsampler=upsampler),
                     optimizer=tstoke.StokeOptimizer(optimizer="AdamW",
                                                     optimizer_kwargs={"lr": 1e-3}),
                     loss=tlosses.mse_loss, device="cpu", verbose=False)
    s.load_model_state(path, strict=True)
    x, _ = _data(8, r)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    s.model_access.eval()
    _assert_out(s.model(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("wrapper,key", [(None, None), ("params", None), ("state_dict", None),
                                         ("model", None), ("params_ema", "params_ema")])
def test_load_torch_checkpoint_unwraps(tmp_path, wrapper, key):
    sd = SwinIR(**BODY).state_dict()
    path = str(tmp_path / "w.pth")
    torch.save(sd if wrapper is None else {wrapper: sd, "epoch": 3}, path)
    got = interop.load_torch_checkpoint(path, key=key)
    assert set(got) == set(sd)
    for k in sd:
        assert torch.equal(got[k], sd[k])


def test_load_torch_checkpoint_refuses_what_is_not_a_state_dict(tmp_path):
    path = str(tmp_path / "w.pth")
    torch.save({"something": {"a": 1}, "b": torch.zeros(1)}, path)
    with pytest.raises(ValueError, match="not a state dict"):
        interop.load_torch_checkpoint(path)
