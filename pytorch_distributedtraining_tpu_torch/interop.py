"""Weight carry-over from the JAX package's models into the port's, and
torch checkpoint files.

Counterpart of the SwinIR, GPT-2 and VGG-16 parts of ``pytorch_distributed
training_tpu/interop.py`` (``torch_swinir_state_dict``,
``torch_gpt2_state_dict``, ``load_torch_checkpoint`` and the
``SWINIR_EXPORT_KEY_MAP`` / ``GPT2_EXPORT_KEY_MAP`` / VGG ``TORCH_KEY_MAP``
beside the JAX models): the same key rewrites, kept here as a copy so the
port imports nothing of the JAX package. The input is the JAX model's
``params`` as a nested dict of numpy arrays (``jax.device_get`` of the
tree); the output strict-loads into ``models.swinir.SwinIR`` (any of its
three tails, from the per-layer or the ``scan_layers=True`` layout),
``models.gpt2.GPT2``, ``models.sr_espcn.Net`` or ``models.vgg.VGG16Features``.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .models.scan_utils import unstack_swinir_layer_params
from .models.swinir import _relative_position_index, _shift_attn_mask

# flat JAX key -> official torch-SwinIR name; leaf-module renames first,
# since later rules rewrite the separators these patterns anchor on
SWINIR_KEY_RULES = [
    (r"/fc1/", "/mlp.fc1/"),
    (r"/fc2/", "/mlp.fc2/"),
    (r"^rstb_(\d+)/layer_(\d+)/", r"layers.\1.residual_group.blocks.\2."),
    (r"^rstb_(\d+)/conv/", r"layers.\1.conv."),
    (r"^patch_norm/", "patch_embed.norm."),
    (r"^conv_up/", "upsample.0."),
    # classical 'pixelshuffle' and real-SR 'nearest+conv' tails; conv_up1,
    # conv_up2, conv_hr and conv_last keep their names
    (r"^conv_before_up/", "conv_before_upsample.0."),
    (r"^up_conv_(\d+)/", lambda m: f"upsample.{2 * int(m.group(1))}."),
]


# flat JAX key -> HF GPT2LMHeadModel name (the JAX GPT2_EXPORT_KEY_MAP)
GPT2_KEY_RULES = [
    (r"^h_(\d+)/c_attn/", r"transformer.h.\1.attn.c_attn."),
    (r"^h_(\d+)/c_proj/", r"transformer.h.\1.attn.c_proj."),
    (r"^h_(\d+)/mlp_fc/", r"transformer.h.\1.mlp.c_fc."),
    (r"^h_(\d+)/mlp_proj/", r"transformer.h.\1.mlp.c_proj."),
    (r"^h_(\d+)/ln_(1|2)/", r"transformer.h.\1.ln_\2."),
    (r"^ln_f/", "transformer.ln_f."),
    (r"^wte$", "transformer.wte.weight"),
    (r"^wpe$", "transformer.wpe.weight"),
]


def _flatten(tree: dict, prefix: str = "") -> dict:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(_flatten(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def _torch_name(key: str) -> str:
    for pat, repl in SWINIR_KEY_RULES:
        key = re.sub(pat, repl, key)
    key = key.replace("/", ".")
    return re.sub(r"\.(kernel|scale)$", ".weight", key)


def swinir_state_dict_from_jax(params: dict, img_size: int = 64) -> dict[str, torch.Tensor]:
    """JAX SwinIR ``params`` -> state dict of the port's ``SwinIR``.

    Conv kernels go HWIO -> OIHW, dense kernels ``[in, out]`` -> ``[out,
    in]``, LayerNorm ``scale`` -> ``weight``. The buffers the port registers
    (``relative_position_index`` on every block, ``attn_mask`` on shifted
    blocks at ``img_size``) are generated, with the window size read from
    the bias tables' shape. ``params`` may be nested under ``"params"``, and
    may come from a ``scan_layers=True`` model (stacked ``layers/{a,b}``
    pairs), which is unstacked first.
    """
    if set(params) == {"params"}:
        params = params["params"]
    params = unstack_swinir_layer_params(params)
    sd: dict[str, torch.Tensor] = {}
    window = None
    blocks = []
    for key, a in _flatten(params).items():
        if key.endswith("/kernel"):
            a = np.transpose(a, (3, 2, 0, 1)) if a.ndim == 4 else a.T
        name = _torch_name(key)
        sd[name] = torch.from_numpy(np.array(a, dtype=np.float32, copy=True))
        m = re.match(r"(layers\.\d+\.residual_group\.blocks\.(\d+))\.attn\."
                     r"relative_position_bias_table$", name)
        if m:
            window = (int(round(a.shape[0] ** 0.5)) + 1) // 2
            blocks.append((m.group(1), int(m.group(2))))
    if window is not None:
        idx = torch.from_numpy(_relative_position_index(window))
        mask = torch.from_numpy(_shift_attn_mask(img_size, img_size, window, window // 2))
        for base, j in blocks:
            sd[f"{base}.attn.relative_position_index"] = idx.clone()
            if j % 2 == 1:  # shifted blocks carry the trained-size mask
                sd[f"{base}.attn_mask"] = mask.clone()
    return sd


def gpt2_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """JAX GPT-2 ``params`` -> state dict of the port's ``GPT2``.

    Dense kernels ``[in, out]`` -> ``nn.Linear`` ``[out, in]``, LayerNorm
    ``scale`` -> ``weight``; the embeddings keep their ``[rows, n_embd]``
    layout. ``params`` may be nested under ``"params"``.
    """
    if set(params) == {"params"}:
        params = params["params"]
    sd: dict[str, torch.Tensor] = {}
    for key, a in _flatten(params).items():
        if key.endswith("/kernel"):
            a = a.T
        name = key
        for pat, repl in GPT2_KEY_RULES:
            name = re.sub(pat, repl, name)
        name = re.sub(r"[./](kernel|scale)$", ".weight", name)
        sd[name] = torch.from_numpy(np.array(a, dtype=np.float32, copy=True))
    return sd


def espcn_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """JAX ESPCN ``Net`` ``params`` -> state dict of the port's ``Net``.

    flax names the three convolutions ``Conv_0``..``Conv_2`` in call order;
    they become ``conv1``..``conv3``, kernels HWIO -> OIHW. ``params`` may be
    nested under ``"params"``.
    """
    if set(params) == {"params"}:
        params = params["params"]
    sd: dict[str, torch.Tensor] = {}
    for key, a in _flatten(params).items():
        m = re.fullmatch(r"Conv_(\d+)/(kernel|bias)", key)
        if m is None:
            raise ValueError(f"not an ESPCN parameter: {key!r}")
        if m.group(2) == "kernel":
            a = np.transpose(a, (3, 2, 0, 1))
        name = f"conv{int(m.group(1)) + 1}.{'weight' if m.group(2) == 'kernel' else 'bias'}"
        sd[name] = torch.from_numpy(np.array(a, dtype=np.float32, copy=True))
    return sd


def vgg16_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """JAX ``VGG16Features`` ``params`` -> state dict of the port's
    ``VGG16Features``: ``conv_N`` becomes ``features.N`` (torchvision's
    index), kernels HWIO -> OIHW. ``params`` may be nested under
    ``"params"``."""
    if set(params) == {"params"}:
        params = params["params"]
    sd: dict[str, torch.Tensor] = {}
    for key, a in _flatten(params).items():
        m = re.fullmatch(r"conv_(\d+)/(kernel|bias)", key)
        if m is None:
            raise ValueError(f"not a VGG16Features parameter: {key!r}")
        if m.group(2) == "kernel":
            a = np.transpose(a, (3, 2, 0, 1))
        name = f"features.{m.group(1)}.{'weight' if m.group(2) == 'kernel' else 'bias'}"
        sd[name] = torch.from_numpy(np.array(a, dtype=np.float32, copy=True))
    return sd


CHECKPOINT_WRAPPERS = ("params", "state_dict", "model")


def load_torch_checkpoint(path: str, key: str | None = None) -> dict[str, torch.Tensor]:
    """A ``.pth``/``.pt`` file -> its flat state dict, read with
    ``torch.load(weights_only=True)`` on the CPU.

    The file may hold the state dict itself or a wrapper around it: under
    ``key`` when given and present (official real-SR SwinIR files nest
    under ``'params_ema'``), else under the first of
    :data:`CHECKPOINT_WRAPPERS` it holds (official classical SwinIR files
    nest under ``'params'``; torchvision's are bare).
    """
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: expected a state dict or a wrapper dict, got {type(obj)}")
    for k in ((key,) if key is not None and key in obj else CHECKPOINT_WRAPPERS):
        if isinstance(obj.get(k), dict):
            obj = obj[k]
            break
    bad = [k for k, v in obj.items() if not isinstance(v, torch.Tensor)]
    if bad:
        raise ValueError(f"{path}: not a state dict; non-tensor entries {bad[:5]}")
    return obj
