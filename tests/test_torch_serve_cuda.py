"""The serving path on the card against the same code on the CPU.

Marked ``cuda``: they need an NVIDIA GPU (and ``nvcc`` for K1) and skip
without one. On a GPU machine, where JAX need not be installed::

    python -m pytest tests/test_torch_serve_cuda.py -q -m cuda --noconftest

Tolerances: f32 with TF32 off; the paged decode logits agree to a few f32
ulps of sum order (held at 1e-5), the greedy tokens of a tiny GPT-2 equal
the CPU's, and the tiny SwinIR tile server's images agree to ~1e-6 (held
at 1e-4, the toy-SwinIR card check of ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from pytorch_distributedtraining_tpu_torch.models import SwinIR
from pytorch_distributedtraining_tpu_torch.models import generate as tgen
from pytorch_distributedtraining_tpu_torch.models import gpt2 as tg
from pytorch_distributedtraining_tpu_torch.ops import window_attn as twa
from pytorch_distributedtraining_tpu_torch.serve.engine import ServeEngine
from pytorch_distributedtraining_tpu_torch.serve.scheduler import Request
from pytorch_distributedtraining_tpu_torch.serve.tiles import SwinIRTileServer, TileRequest

pytestmark = pytest.mark.cuda

CFG = tg.GPT2Config.tiny(n_embd=32, n_head=4, n_positions=96)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the serving path's kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _state_dict():
    return tg.GPT2(CFG, generator=torch.Generator().manual_seed(0)).state_dict()


def test_paged_decode_on_card_matches_cpu(cuda):
    sd = _state_dict()
    prompt = np.random.default_rng(0).integers(0, CFG.vocab_size, (2, 9))
    out = {}
    for dev in ("cpu", cuda):
        model = tg.GPT2(CFG, decode=True).to(dev)
        model.load_state_dict(sd)
        cache = tgen.init_paged_cache(model, 1 + 2 * 6, 4)
        table = (1 + torch.arange(2)[:, None] * 6 + torch.arange(6)[None]).to(dev)
        with torch.no_grad():
            logits = model(torch.from_numpy(prompt).to(dev), cache, page_table=table,
                           lengths=torch.zeros(2, dtype=torch.long, device=dev))
        out[str(dev)] = logits.cpu()
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("spec_k", [0, 3])
def test_engine_on_card_matches_cpu(cuda, spec_k):
    sd = _state_dict()
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, CFG.vocab_size, n) for n in (5, 11, 3, 20, 7)]
    toks = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(CFG, sd, n_slots=3, page_size=8, max_len=48, prefill_chunk=16,
                          prefill_buckets=(8, 16), spec_k=spec_k, device=dev)
        recs = eng.run([Request(i, p, 6) for i, p in enumerate(prompts)], realtime=False)
        assert eng.steady_recompiles() == 0 and eng.pool.in_use == 0
        toks[dev] = {r["rid"]: r["tokens"] for r in recs}
    assert toks["cuda"] == toks["cpu"]


def test_tile_server_on_card_runs_k1_and_matches_cpu(cuda):
    model = SwinIR(upscale=2, embed_dim=12, depths=(2, 2), num_heads=(2, 2), window_size=4,
                   img_size=16, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    images = [rng.random((h, w, 3)).astype(np.float32) for h, w in ((24, 20), (16, 16), (12, 10))]
    out = {}
    for dev in ("cpu", "cuda"):
        srv = SwinIRTileServer(model, tile=16, tile_batch=2, overlap=4, device=dev)
        srv.warmup()
        twa.reset_launch_counts()
        recs = srv.run([TileRequest(i, im) for i, im in enumerate(images)])
        launches = (twa.fwd_launches, twa.bwd_launches)
        assert launches == ((4 * srv.metrics()["ticks"], 0) if dev == "cuda" else (0, 0))
        out[dev] = {r["rid"]: r["image"] for r in recs}
    for rid, img in out["cpu"].items():
        np.testing.assert_allclose(out["cuda"][rid], img, atol=1e-4)
