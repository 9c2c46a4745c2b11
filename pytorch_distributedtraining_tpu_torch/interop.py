"""Weight carry-over from the JAX package's SwinIR, GPT-2 and ESPCN into the port's.

Counterpart of the SwinIR and GPT-2 parts of ``pytorch_distributedtraining_
tpu/interop.py`` (``torch_swinir_state_dict``, ``torch_gpt2_state_dict`` and
the ``SWINIR_EXPORT_KEY_MAP`` / ``GPT2_EXPORT_KEY_MAP`` beside the JAX
models): the same key rewrites, kept here as a copy so the port imports
nothing of the JAX package. The input is the JAX model's ``params`` as a
nested dict of numpy arrays (``jax.device_get`` of the tree); the output
strict-loads into ``models.swinir.SwinIR``, ``models.gpt2.GPT2`` or
``models.sr_espcn.Net``.
"""

from __future__ import annotations

import re

import numpy as np
import torch

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
    the bias tables' shape. ``params`` may be nested under ``"params"``.
    """
    if set(params) == {"params"}:
        params = params["params"]
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
