"""Weight carry-over from the JAX package's SwinIR into the port's SwinIR.

Counterpart of the SwinIR part of ``pytorch_distributedtraining_tpu/
interop.py`` (``torch_swinir_state_dict`` and the ``SWINIR_EXPORT_KEY_MAP``
beside the JAX model): the same key rewrites, kept here as a copy so the
port imports nothing of the JAX package. The input is the JAX model's
``params`` as a nested dict of numpy arrays (``jax.device_get`` of the
tree); the output strict-loads into ``models.swinir.SwinIR``.
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
