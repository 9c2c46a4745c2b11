"""The interop remainder: ``.safetensors`` files, HF ``Conv1D`` GPT-2
files, and the port's weights crossing into the JAX models.

- ``.safetensors`` (f32, bf16, int64, an empty tensor), written by the
  ``safetensors`` package here: the port's own parser reads the tensors the
  JAX package's reader reads (bf16 there widened to f32), bit for bit, and
  keeps bf16 as bf16. ``Stoke.load_model_state`` takes the file.
- GPT-2: the tiny model's state dict written in HF's ``Conv1D`` layout
  (``[in, out]`` linears, with the causal-mask buffers and the tied
  ``lm_head``), as ``.safetensors`` and as ``.pth``, loads through
  ``gpt2_state_dict_from_hf`` to the same logits as the ``nn.Linear``
  layout, bitwise.
- Port -> JAX: the port's SwinIR and GPT-2 state dicts, saved with
  ``torch.save``, load into the JAX models through JAX's ``TORCH_KEY_MAP``
  and ``HF_KEY_MAP`` with ``load_torch_into_template``: SwinIR's outputs
  within 1e-5 (they agree to ~6e-7), GPT-2's logits within 1e-4 (~1e-7;
  ``test_torch_gpt2.py``'s bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import save_file

from pytorch_distributedtraining_tpu import interop as jinterop
from pytorch_distributedtraining_tpu.checkpoint import tree_to_flat_dict
from pytorch_distributedtraining_tpu.models import gpt2 as jg
from pytorch_distributedtraining_tpu.models.swinir import TORCH_KEY_MAP
from pytorch_distributedtraining_tpu.models.swinir import SwinIR as JaxSwinIR
from pytorch_distributedtraining_tpu_torch import interop
from pytorch_distributedtraining_tpu_torch.models import SwinIR
from pytorch_distributedtraining_tpu_torch.models import gpt2 as tg
from test_torch_dist_workers import facade, toy_swinir

TOY = dict(upscale=2, in_chans=3, img_size=8, window_size=4, depths=(2, 2),
           embed_dim=12, num_heads=(2, 2), mlp_ratio=2.0)


def test_safetensors_reads_as_the_jax_reader_does(tmp_path):
    g = torch.Generator().manual_seed(0)
    sd = {"a.w": torch.randn(3, 4, generator=g),
          "a.b": torch.randn(5, generator=g).to(torch.bfloat16),
          "idx": torch.arange(6, dtype=torch.int64).reshape(2, 3),
          "empty": torch.empty(0, 3)}
    path = str(tmp_path / "x.safetensors")
    save_file(sd, path, metadata={"format": "pt"})
    got = interop.load_torch_checkpoint(path)
    want = tree_to_flat_dict(jinterop.load_torch_checkpoint(path))
    assert set(got) == set(sd) and {k.replace("/", ".") for k in want} == set(sd)
    for k, t in sd.items():
        assert got[k].dtype == t.dtype and torch.equal(got[k], t), k
        np.testing.assert_array_equal(got[k].float().numpy(), want[k.replace(".", "/")],
                                      err_msg=k)


def test_load_model_state_takes_a_safetensors_file(tmp_path):
    src = toy_swinir()
    path = str(tmp_path / "swinir.safetensors")
    save_file({k: v.contiguous() for k, v in src.state_dict().items()}, path)
    s = facade(SwinIR(**TOY))
    s.load_model_state(path)
    for (n, p), q in zip(s.model_access.named_parameters(), src.parameters()):
        assert torch.equal(p, q), n


def _hf_layout(state: dict, n_layer: int, n_positions: int) -> dict:
    """The port's GPT-2 state dict as HF writes it: ``Conv1D`` weights
    ``[in, out]``, the causal-mask buffers, the tied head."""
    out = {}
    for k, v in state.items():
        conv1d = k.endswith(("c_attn.weight", "c_proj.weight", "c_fc.weight"))
        out[k] = v.t().contiguous() if conv1d else v.clone()
    mask = torch.tril(torch.ones(n_positions, n_positions)).view(1, 1, n_positions, n_positions)
    for i in range(n_layer):
        out[f"transformer.h.{i}.attn.bias"] = mask.clone()
        out[f"transformer.h.{i}.attn.masked_bias"] = torch.tensor(-1e4)
    out["lm_head.weight"] = state["transformer.wte.weight"].clone()
    return out


@pytest.mark.parametrize("suffix", [".safetensors", ".pth"])
def test_hf_conv1d_gpt2_file_loads_to_the_same_logits(tmp_path, suffix):
    cfg = tg.GPT2Config.tiny(n_positions=32)
    ref = tg.GPT2(cfg, generator=torch.Generator().manual_seed(0))
    hf = _hf_layout(ref.state_dict(), cfg.n_layer, cfg.n_positions)
    path = str(tmp_path / f"gpt2{suffix}")
    save_file(hf, path) if suffix == ".safetensors" else torch.save(hf, path)
    model = tg.GPT2(cfg)
    model.load_state_dict(interop.gpt2_state_dict_from_hf(interop.load_torch_checkpoint(path)),
                          strict=True)
    tok = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16)))
    with torch.no_grad():
        assert torch.equal(model(tok), ref(tok))
    # a file already in the nn.Linear layout, with HF's names
    linear = {k: v for k, v in ref.state_dict().items()}
    again = tg.GPT2(cfg)
    again.load_state_dict(interop.gpt2_state_dict_from_hf(linear, conv1d_kernels=False),
                          strict=True)
    with torch.no_grad():
        assert torch.equal(again(tok), ref(tok))


def test_port_swinir_loads_into_jax_through_torch_key_map(tmp_path):
    port = toy_swinir()
    path = str(tmp_path / "swinir.pth")
    torch.save(port.state_dict(), path)
    jmodel = JaxSwinIR(**TOY)
    template = jax.device_get(jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)))["params"])
    params = jinterop.load_torch_into_template(jinterop.load_torch_checkpoint(path), template,
                                               key_map=TORCH_KEY_MAP, strict=True)
    x = np.random.default_rng(2).random((2, 8, 8, 3), dtype=np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmodel.apply({"params": params}, x)), atol=1e-5)


def test_port_gpt2_loads_into_jax_through_hf_key_map(tmp_path):
    tcfg = tg.GPT2Config.tiny(n_positions=32)
    port = tg.GPT2(tcfg, generator=torch.Generator().manual_seed(0))
    path = str(tmp_path / "gpt2.pth")
    torch.save(port.state_dict(), path)
    jmodel = jg.GPT2(jg.GPT2Config.tiny(n_positions=32))
    template = jax.device_get(jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    params = jinterop.load_torch_into_template(jinterop.load_torch_checkpoint(path),
                                               template["params"], key_map=jg.HF_KEY_MAP,
                                               strict=True)
    tok = np.random.default_rng(3).integers(0, tcfg.vocab_size, (2, 16)).astype(np.int32)
    with torch.no_grad():
        got = port(torch.from_numpy(tok).long()).numpy()
    np.testing.assert_allclose(got, np.asarray(jmodel.apply({"params": params}, tok)), atol=1e-4)
