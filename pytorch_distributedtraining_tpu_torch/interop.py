"""Weight carry-over from the JAX package's models into the port's, and
torch checkpoint files.

Counterpart of the SwinIR, GPT-2, VGG-16, ResNet and ViT parts of
``pytorch_distributedtraining_tpu/interop.py`` (``torch_swinir_state_dict``,
``torch_gpt2_state_dict``, ``load_torch_checkpoint`` and the
``SWINIR_EXPORT_KEY_MAP`` / ``GPT2_EXPORT_KEY_MAP`` / VGG ``TORCH_KEY_MAP``
/ ``RESNET*_KEY_MAP`` / ``VIT_KEY_MAP`` beside the JAX models): the same
key rewrites, kept here as a copy so the port imports nothing of the JAX
package. The input is the JAX model's ``params`` (and ResNet's
``batch_stats``) as a nested dict of numpy arrays (``jax.device_get`` of
the tree); the output strict-loads into ``models.swinir.SwinIR`` (any of
its three tails, from the per-layer or the ``scan_layers=True`` layout),
``models.gpt2.GPT2``, ``models.sr_espcn.Net``, ``models.vgg.VGG16Features``,
``models.resnet.ResNet`` or ``models.vit.ViT``.

Files: :func:`load_torch_checkpoint` reads ``.pth``/``.pt`` with
``torch.load`` and ``.safetensors`` with :func:`load_safetensors`, a parser
of the format itself (an 8-byte little-endian header length, a JSON
header, raw little-endian bytes; BF16 included), so no ``safetensors``
package is needed. :func:`gpt2_state_dict_from_hf` takes an HF GPT-2 state
dict, whose ``Conv1D`` linears store ``[in, out]`` (JAX's
``conv1d_kernels=True``), into the port's ``nn.Linear`` layout; its
``lm_head.weight`` is kept for an untied model and dropped for a tied one.
:func:`jax_leading_axes` names, for each parameter of a port module, the
axis that is the JAX leaf's leading one under the transposes these maps
make (the numerics probe's ``bad_layer`` reads along it).
:func:`params_from_jax_portable` reads the parameters out of a portable
checkpoint the JAX package wrote, for the ``*_state_dict_from_jax`` maps.
"""

from __future__ import annotations

import json
import re
import struct

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

    Dense kernels ``[in, out]`` -> ``nn.Linear`` ``[out, in]`` (an untied
    model's ``lm_head/kernel`` ``[n_embd, vocab]`` -> ``lm_head.weight``
    ``[vocab, n_embd]``), LayerNorm ``scale`` -> ``weight``; the embeddings
    keep their ``[rows, n_embd]`` layout. ``params`` may be nested under
    ``"params"``.
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


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _resnet_blocks(params: dict) -> list[str]:
    """flax's global block instances (``BasicBlock_{g}`` or
    ``BottleneckBlock_{g}``) in call order."""
    blocks = [k for k in params if re.fullmatch(r"(Basic|Bottleneck)Block_\d+", k)]
    return sorted(blocks, key=lambda k: int(k.rsplit("_", 1)[1]))


def resnet_state_dict_from_jax(params: dict, batch_stats: dict) -> dict[str, torch.Tensor]:
    """JAX ResNet ``params`` and ``batch_stats`` -> state dict of the port's
    ``ResNet`` (torchvision's names).

    flax numbers block instances globally (``BasicBlock_{g}``, inside it
    ``Conv_{c}`` / ``BatchNorm_{c}`` and the projection ``conv_proj`` /
    ``norm_proj``); torchvision per stage (``layer{i}.{j}.conv{c+1}`` /
    ``bn{c+1}``, ``downsample.0`` / ``.1``). JAX's ``torchvision_key_map`` is
    this table read the other way. The stages are read off the tree: a
    stage starts at the first block and at every block with a projection
    (each later stage opens with a stride-2 one). Conv kernels go HWIO -> OIHW, the head's ``[in, out]`` ->
    ``[out, in]``, BatchNorm ``scale`` -> ``weight``, ``mean`` / ``var`` ->
    ``running_mean`` / ``running_var``; ``num_batches_tracked``, which flax
    does not keep, is 0. ``params`` may be nested under ``"params"``.
    """
    if set(params) == {"params"}:
        params = params["params"]
    if set(batch_stats) == {"batch_stats"}:
        batch_stats = batch_stats["batch_stats"]
    blocks = _resnet_blocks(params)
    starts = [g for g, b in enumerate(blocks) if g == 0 or "conv_proj" in params[b]]
    stage_sizes = [e - s for s, e in zip(starts, starts[1:] + [len(blocks)])]
    names = {"conv_init": "conv1", "bn_init": "bn1", "head": "fc"}
    g = 0
    for i, n in enumerate(stage_sizes):
        for j in range(n):
            base = f"layer{i + 1}.{j}"
            names[f"{blocks[g]}/conv_proj"] = f"{base}.downsample.0"
            names[f"{blocks[g]}/norm_proj"] = f"{base}.downsample.1"
            for c in range(3):
                names[f"{blocks[g]}/Conv_{c}"] = f"{base}.conv{c + 1}"
                names[f"{blocks[g]}/BatchNorm_{c}"] = f"{base}.bn{c + 1}"
            g += 1
    leaf = {"kernel": "weight", "scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}
    sd: dict[str, torch.Tensor] = {}
    for key, a in {**_flatten(params), **_flatten(batch_stats)}.items():
        module, name = key.rsplit("/", 1)
        if name == "kernel":
            a = np.transpose(a, (3, 2, 0, 1)) if a.ndim == 4 else a.T
        sd[f"{names[module]}.{leaf[name]}"] = _tensor(a)
        if name == "var":
            sd[f"{names[module]}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


# flat JAX key -> torchvision vit_b_16 name (the JAX VIT_KEY_MAP read backwards)
VIT_KEY_RULES = [
    (r"^cls$", "class_token"),
    (r"^patch_embed/", "conv_proj/"),
    (r"^pos_embed$", "encoder/pos_embedding"),
    (r"^encoder_(\d+)/", r"encoder/layers/encoder_layer_\1/"),
    (r"/c_attn/kernel$", "/self_attention/in_proj_weight"),
    (r"/c_attn/bias$", "/self_attention/in_proj_bias"),
    (r"/c_proj/", "/self_attention/out_proj/"),
    (r"/mlp_fc/", "/mlp/0/"),
    (r"/mlp_proj/", "/mlp/3/"),
    (r"^ln_f/", "encoder/ln/"),
    (r"^head/", "heads/head/"),
]


def vit_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """JAX ViT ``params`` (the per-layer layout) -> state dict of the port's
    ``ViT`` (torchvision's ``vit_b_16`` names).

    ``c_attn``'s ``[d, 3d]`` kernel (columns ``[q | k | v]``) becomes
    ``in_proj_weight`` ``[3d, d]`` (rows ``[q; k; v]``), dense kernels
    ``[in, out]`` -> ``[out, in]``, the patch convolution HWIO -> OIHW,
    LayerNorm ``scale`` -> ``weight``; ``cls`` and ``pos_embed`` keep their
    ``[1, T, d]`` shapes. ``params`` may be nested under ``"params"``.
    """
    if set(params) == {"params"}:
        params = params["params"]
    sd: dict[str, torch.Tensor] = {}
    for key, a in _flatten(params).items():
        if key.endswith("/kernel"):
            a = np.transpose(a, (3, 2, 0, 1)) if a.ndim == 4 else a.T
        name = key
        for pat, repl in VIT_KEY_RULES:
            name = re.sub(pat, repl, name)
        name = re.sub(r"/(kernel|scale)$", "/weight", name).replace("/", ".")
        sd[name] = _tensor(a)
    return sd


CHECKPOINT_WRAPPERS = ("params", "state_dict", "model")


def load_torch_checkpoint(path: str, key: str | None = None) -> dict[str, torch.Tensor]:
    """A ``.pth``/``.pt`` file -> its flat state dict, read with
    ``torch.load(weights_only=True)`` on the CPU; a ``.safetensors`` file
    through :func:`load_safetensors` (flat by format).

    The file may hold the state dict itself or a wrapper around it: under
    ``key`` when given and present (official real-SR SwinIR files nest
    under ``'params_ema'``), else under the first of
    :data:`CHECKPOINT_WRAPPERS` it holds (official classical SwinIR files
    nest under ``'params'``; torchvision's are bare).
    """
    if path.endswith(".safetensors"):
        return load_safetensors(path)
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


# safetensors dtype names -> torch (float8 where this torch has it)
SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
    **{name: getattr(torch, attr) for name, attr in (("F8_E4M3", "float8_e4m3fn"),
                                                      ("F8_E5M2", "float8_e5m2"))
       if hasattr(torch, attr)},
}


def load_safetensors(path: str) -> dict[str, torch.Tensor]:
    """A ``.safetensors`` file -> its flat state dict on the CPU: the
    8-byte little-endian header length, the JSON header (``dtype``,
    ``shape``, ``data_offsets`` per tensor, an optional ``__metadata__``),
    then each tensor's raw little-endian bytes, read with
    ``torch.frombuffer``."""
    with open(path, "rb") as fh:
        (n,) = struct.unpack("<Q", fh.read(8))
        header = json.loads(fh.read(n))
        data = fh.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, which this "
                             f"reader does not know ({sorted(SAFETENSORS_DTYPES)})")
        start, stop = info["data_offsets"]
        raw = bytearray(data[start:stop])
        flat = torch.frombuffer(raw, dtype=dtype) if raw else torch.empty(0, dtype=dtype)
        out[name] = flat.reshape(info["shape"])
    return out


# the HF GPT-2 linears, Conv1D modules that store their weight as [in, out]
_HF_CONV1D = re.compile(r"\.(attn\.c_attn|attn\.c_proj|mlp\.c_fc|mlp\.c_proj)\.weight$")
# HF buffers the port's GPT-2 does not hold, and the head a tied model shares
# with wte
_HF_DROP = re.compile(r"\.attn\.(bias|masked_bias)$")
_HF_HEAD = "lm_head.weight"


def gpt2_state_dict_from_hf(state: dict, conv1d_kernels: bool = True,
                            tie_word_embeddings: bool = True) -> dict[str, torch.Tensor]:
    """An HF GPT-2 state dict (``GPT2LMHeadModel``'s, or ``GPT2Model``'s
    without the ``transformer.`` prefix) -> the port's ``GPT2``'s.

    HF's ``c_attn``, ``c_proj`` and ``c_fc`` are ``Conv1D`` modules whose
    weight is ``[in, out]``; with ``conv1d_kernels`` (the default, as JAX's
    ``load_torch_into_template(conv1d_kernels=True)``) they are transposed
    to ``nn.Linear``'s ``[out, in]``; pass False for a file already in the
    ``nn.Linear`` layout. The causal-mask buffers (``attn.bias``,
    ``attn.masked_bias``) are dropped, and so is ``lm_head.weight`` (an
    ``nn.Linear`` ``[vocab, n_embd]`` in HF, kept as it is) unless the
    port's config is untied (``tie_word_embeddings=False``)."""
    sd = {}
    for k, v in state.items():
        if not k.startswith(("transformer.", "lm_head.")):
            k = f"transformer.{k}"
        if _HF_DROP.search(k) or (k == _HF_HEAD and tie_word_embeddings):
            continue
        v = torch.as_tensor(v)
        sd[k] = v.t().contiguous() if conv1d_kernels and _HF_CONV1D.search(k) else v
    return sd


def jax_leading_axes(module: torch.nn.Module) -> dict[str, int]:
    """``{parameter name: axis}``: the axis of each port parameter that is
    its JAX leaf's leading axis. The maps above transpose every JAX
    ``kernel``: a dense ``[in, out]`` becomes ``nn.Linear``'s (and
    ``nn.MultiheadAttention``'s packed) ``[out, in]``, so JAX's axis 0 is
    axis 1 here; a convolution HWIO becomes OIHW, so JAX's axis 0 (kernel
    height) is axis 2. Every other leaf keeps its layout (axis 0)."""
    axes = {}
    for prefix, m in module.named_modules():
        dot = f"{prefix}." if prefix else ""
        if isinstance(m, torch.nn.Linear):
            axes[f"{dot}weight"] = 1
        elif isinstance(m, torch.nn.Conv2d):
            axes[f"{dot}weight"] = 2
        elif isinstance(m, torch.nn.MultiheadAttention):
            axes[f"{dot}in_proj_weight"] = 1
    return {name: axes.get(name, 0) for name, _ in module.named_parameters()}


def params_from_jax_portable(path: str) -> dict:
    """The parameters of a portable checkpoint the JAX package wrote
    (``save_portable``, a directory with a ``_COMMIT`` marker) as a nested
    dict of numpy arrays, the input of the ``*_state_dict_from_jax`` maps.
    JAX names leaves by ``keystr`` path (``.params['conv_first']['kernel']``
    for a train state, ``['params']['conv_first']['kernel']`` for a dict);
    bfloat16 leaves come back as float32. A scanned SwinIR's stacked pairs
    stay stacked (the SwinIR map unstacks them)."""
    from .checkpoint_sharded import _assemble_host_tree, host_tensor

    manifest, host = _assemble_host_tree(path)
    head = re.compile(r"^(\.params|\['params'\])")
    out: dict = {}
    for key, arr in host.items():
        m = head.match(key)
        if not m:
            continue
        parts = re.findall(r"\['([^']*)'\]|\[(\d+)\]", key[m.end():])
        node = out
        names = [a or b for a, b in parts]
        for p in names[:-1]:
            node = node.setdefault(p, {})
        t = host_tensor(arr, manifest["leaves"][key]["dtype"])
        node[names[-1]] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if not out:
        raise ValueError(f"{path}: no parameter leaf (leaves: "
                         f"{sorted(host)[:5]}...)")
    return out
