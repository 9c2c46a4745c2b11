"""The port's ViT (``models/vit.py``) against the JAX package's.

``ViTConfig.tiny()`` (32x32 images, patch 8: 16 patches and the CLS
token, width 32, 2 heads, 2 blocks) with weights from the JAX init plus
seeded noise (the JAX init zeroes the head and the CLS token), carried
with ``interop.vit_state_dict_from_jax``; images from a numpy seed.

Tolerances: in f32 logits within 1e-5 of the largest logit and parameter
gradients within 1e-4 of the largest gradient entry (f32 sums in another
order). In bf16 both sides round the same f32 values to bf16 at the same
points (the residual stream, every dense output, the attention logits),
so they differ by a few bf16 steps (2^-8 relative) that the blocks carry
on: logits are held at 3e-2 of the largest logit and gradients at 5e-2
of the largest entry.

Also here: a torchvision ``vit_b_16``-named state dict (synthesized as
the JAX interop test does, with ``nn.MultiheadAttention``'s packed
``in_proj_weight``) loads strictly into the port and, through JAX's
``VIT_KEY_MAP``, into the JAX model with the same logits; per-block remat
gives the same numbers; dropout with JAX's captured masks gives JAX's
numbers at the f32 tolerances; the options that wait for later slices
raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributedtraining_tpu import interop as jinterop
from pytorch_distributedtraining_tpu.checkpoint import tree_to_flat_dict
from pytorch_distributedtraining_tpu.models import vit as jvit
from pytorch_distributedtraining_tpu_torch.interop import vit_state_dict_from_jax
from pytorch_distributedtraining_tpu_torch.models import vit as tvit
from test_interop_vit import _to_torch_name

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5, 1e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2, 5e-2)}


def jax_params(jm, cfg, seed: int = 0):
    v = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, cfg.image_size, cfg.image_size, 3)))
    rng = np.random.default_rng(seed + 1)
    return jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(
        np.float32), v["params"])


def images(cfg, n: int = 3, seed: int = 0):
    return np.random.default_rng(seed).normal(
        size=(n, cfg.image_size, cfg.image_size, 3)).astype(np.float32)


def close_rel(got, want, rel, err_msg=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rel * np.abs(want).max(), err_msg=err_msg)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_forward_and_grads_match_jax(dtype):
    jdt, tdt, out_tol, grad_tol = DTYPES[dtype]
    jcfg = jvit.ViTConfig.tiny(dtype=jdt)
    jm = jvit.ViT(jcfg)
    params = jax_params(jm, jcfg)
    x = images(jcfg)

    def f(p):
        out = jm.apply({"params": p}, x)
        return jnp.mean(out ** 2), out

    (_, want), grads = jax.value_and_grad(f, has_aux=True)(params)
    tm = tvit.ViT(tvit.ViTConfig.tiny(dtype=tdt))
    tm.load_state_dict(vit_state_dict_from_jax(params), strict=True)
    got = tm(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    got.square().mean().backward()
    close_rel(got.detach(), want, out_tol)
    want_g = vit_state_dict_from_jax(jax.device_get(grads))
    scale = max(float(g.abs().max()) for g in want_g.values())
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(), rtol=0,
                                   atol=grad_tol * scale, err_msg=name)


def test_torchvision_state_dict_loads_into_both_packages():
    cfg = jvit.ViTConfig.tiny()
    jm = jvit.ViT(cfg)
    template = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
    sd = {}
    for k, v in tree_to_flat_dict(template).items():
        a = np.asarray(v, np.float32) + 0.05 * np.random.default_rng(len(sd)).normal(
            size=v.shape).astype(np.float32)
        if k.endswith("/kernel"):
            a = np.transpose(a, (3, 2, 0, 1)) if a.ndim == 4 else a.T
        sd[_to_torch_name(k)] = torch.from_numpy(np.ascontiguousarray(a))
    tm = tvit.ViT(tvit.ViTConfig.tiny())
    tm.load_state_dict(sd, strict=True)
    loaded = jinterop.load_torch_into_template(jinterop._to_numpy_tree(sd), template,
                                               key_map=jvit.VIT_KEY_MAP, strict=True)
    x = images(cfg, seed=2)
    want = jm.apply({"params": loaded}, x)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    close_rel(got, want, 1e-5)
    back = vit_state_dict_from_jax(jax.device_get(loaded))
    assert set(back) == set(sd)
    for k, t in sd.items():
        np.testing.assert_allclose(back[k].numpy(), t.numpy(), atol=1e-6, err_msg=k)


def test_vit_b16_has_torchvision_shapes():
    m = tvit.ViTB16()
    assert m.cfg == tvit.ViTConfig.b16() and m.cfg.dtype == torch.bfloat16
    sd = m.state_dict()
    assert sd["encoder.pos_embedding"].shape == (1, 197, 768)
    assert sd["encoder.layers.encoder_layer_11.self_attention.in_proj_weight"].shape == (2304, 768)
    assert sd["conv_proj.weight"].shape == (768, 3, 16, 16)
    assert sum(p.numel() for p in m.parameters()) == 86_567_656  # torchvision's vit_b_16
    assert [id(b) for b in m.fsdp_blocks()] == [id(b) for b in m.encoder.layers]
    assert not m.heads.head.weight.detach().any() and not m.class_token.detach().any()


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_per_block_remat_gives_the_same_numbers(remat):
    cfg = tvit.ViTConfig.tiny()
    ref = tvit.ViT(cfg, generator=torch.Generator().manual_seed(0))
    ckpt = tvit.ViT(tvit.ViTConfig.tiny(remat=remat))
    ckpt.load_state_dict(ref.state_dict())
    with torch.no_grad():  # the init zeroes the head: give the logits a slope
        for m in (ref, ckpt):
            m.heads.head.weight.normal_(generator=torch.Generator().manual_seed(1))
    x = torch.from_numpy(images(cfg))
    for m in (ref, ckpt):
        m(x).square().mean().backward()
    for (name, a), b in zip(ref.named_parameters(), ckpt.parameters()):
        np.testing.assert_allclose(b.grad.numpy(), a.grad.numpy(), rtol=0, atol=1e-7,
                                   err_msg=name)


@pytest.mark.parametrize("kw,match", [(dict(scan_layers=True), "scan-over-layers slice"),
                                      (dict(fp8="e4m3"), "fp8 matmul slice")])
def test_options_of_later_slices_raise(kw, match):
    with pytest.raises(NotImplementedError, match=match):
        tvit.ViT(tvit.ViTConfig.tiny(**kw))


@pytest.mark.parametrize("remat", [False, "full"])
def test_dropout_with_jax_masks_matches_jax(remat):
    """Dropout 0.1 with JAX's own masks (captured in call order: the
    embedding, then each block's c_proj and mlp_proj, the port's sites 0,
    1 + 2i, 2 + 2i) fed to the port: the f32 tolerances above; the same
    with per-block remat on both sides."""
    from test_torch_gpt2 import ReplayMasks, capture_jax_masks

    jcfg = jvit.ViTConfig.tiny(dropout=0.1, remat=remat)
    jm = jvit.ViT(jcfg)
    params = jax_params(jm, jcfg)
    x = images(jcfg)
    key = jax.random.PRNGKey(3)

    def f(model):
        def loss(p):
            out = model.apply({"params": p}, x, deterministic=False, rngs={"dropout": key})
            return jnp.mean(out ** 2), out
        return loss

    plain = jvit.ViT(jvit.ViTConfig.tiny(dropout=0.1))  # flax's remat traces: masks from here
    _, masks = capture_jax_masks(lambda: plain.apply({"params": params}, x, deterministic=False,
                                                     rngs={"dropout": key}))
    (_, want), grads = jax.value_and_grad(f(jm), has_aux=True)(params)
    assert len(masks) == 1 + 2 * jcfg.num_layers
    tm = tvit.ViT(tvit.ViTConfig.tiny(dropout=0.1, remat=remat))
    tm.load_state_dict(vit_state_dict_from_jax(params), strict=True)
    source = ReplayMasks(masks)
    got = tm(torch.from_numpy(x), deterministic=False, generator=source)
    got.square().mean().backward()
    assert sorted(set(source.sites)) == list(range(len(masks)))
    close_rel(got.detach(), want, 1e-5)
    want_g = vit_state_dict_from_jax(jax.device_get(grads))
    scale = max(float(g.abs().max()) for g in want_g.values())
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(), rtol=0,
                                   atol=1e-4 * scale, err_msg=name)
    with torch.no_grad():  # deterministic (the default): JAX's deterministic logits
        close_rel(tm(torch.from_numpy(x)), jm.apply({"params": params}, x), 1e-5)
