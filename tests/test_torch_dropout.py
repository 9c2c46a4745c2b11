"""The port's dropout stream (``parallel/rng.py``) and its replay.

JAX draws dropout masks from ``fold_in(fold_in(state.rng, step), micro)``;
the port draws each from a generator seeded by ``(seed, step, micro,
site)``. These tests hold the properties that make a run reproducible
(the masks with JAX's own numbers are held in ``tests/test_torch_gpt2.py``
and ``tests/test_torch_vit.py``):

- the same key gives the same masks, bitwise; another step, micro-batch,
  site or seed gives other masks, and the kept share is near ``1 - rate``;
- a forward that ``torch.utils.checkpoint`` recomputes draws the same
  masks again: GPT-2 and ViT gradients under ``remat`` (full and dots)
  equal those without, bitwise;
- ``TrainStep`` hands a keyed ``loss_fn`` a key that changes with the step
  and the micro-batch, advances its stream once a step, and calls a
  two-argument ``loss_fn`` as before;
- a run saved at step 2 (``TrainState.state_dict``, and the portable
  format through ``CheckpointManager``) and resumed in a fresh train state
  takes steps 3-4 bitwise as the unbroken run does, dropout 0.1 included.
"""

import functools

import numpy as np
import pytest
import torch

from pytorch_distributedtraining_tpu_torch import optim
from pytorch_distributedtraining_tpu_torch.checkpoint_sharded import CheckpointManager
from pytorch_distributedtraining_tpu_torch.models import gpt2 as tg
from pytorch_distributedtraining_tpu_torch.models import vit as tv
from pytorch_distributedtraining_tpu_torch.parallel import TrainStep, create_train_state
from pytorch_distributedtraining_tpu_torch.parallel.rng import (DropoutKey, StepRng, as_key,
                                                                dropout, mix_seed)

torch.set_num_threads(1)


def test_masks_are_a_function_of_the_key_and_the_site():
    x = torch.ones(64, 128)
    a = dropout(x, 0.25, DropoutKey(5, 3, 1), site=2, deterministic=False)
    assert torch.equal(a, dropout(x, 0.25, DropoutKey(5, 3, 1), 2, False))
    for other in (DropoutKey(5, 4, 1), DropoutKey(5, 3, 0), DropoutKey(6, 3, 1)):
        assert not torch.equal(a, dropout(x, 0.25, other, 2, False))
    assert not torch.equal(a, dropout(x, 0.25, DropoutKey(5, 3, 1), 3, False))
    kept = (a != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.02
    torch.testing.assert_close(a[a != 0], torch.full_like(a[a != 0], 1 / 0.75))
    # a torch.Generator is refused: nothing would advance it between steps
    with pytest.raises(TypeError, match="DropoutKey"):
        as_key(torch.Generator().manual_seed(5))
    assert len({mix_seed(1, s, 0, 0) for s in range(1000)}) == 1000


def test_rate_zero_one_and_deterministic():
    x = torch.randn(8, 8)
    assert dropout(x, 0.5, None, 0, deterministic=True) is x
    assert dropout(x, 0.0, None, 0, deterministic=False) is x
    assert not dropout(x, 1.0, None, 0, deterministic=False).any()
    with pytest.raises(ValueError, match="generator"):
        dropout(x, 0.5, None, 0, deterministic=False)


def _gpt2(remat, **kw):
    return tg.GPT2(tg.GPT2Config.tiny(dropout=0.1, remat=remat, **kw),
                   generator=torch.Generator().manual_seed(0))


def _vit(remat):
    m = tv.ViT(tv.ViTConfig.tiny(dropout=0.1, remat=remat),
               generator=torch.Generator().manual_seed(0))
    with torch.no_grad():  # the init zeroes the head: give the logits a slope
        m.heads.head.weight.normal_(generator=torch.Generator().manual_seed(1))
    return m


@pytest.mark.parametrize("remat", [True, "dots"])
@pytest.mark.parametrize("model", ["gpt2", "vit"])
def test_remat_replays_the_masks(model, remat):
    rng = np.random.default_rng(0)
    if model == "gpt2":
        ref, ckpt = _gpt2(False, tie_word_embeddings=False), _gpt2(remat,
                                                                   tie_word_embeddings=False)
        x = torch.from_numpy(rng.integers(0, 256, (2, 24)))
    else:
        ref, ckpt = _vit(False), _vit(remat)
        x = torch.from_numpy(rng.normal(size=(2, 32, 32, 3)).astype(np.float32))
    ckpt.load_state_dict(ref.state_dict())
    key = DropoutKey(11, 2, 1)
    outs = []
    for m in (ref, ckpt):
        out = m(x, deterministic=False, generator=key)
        out.square().mean().backward()
        outs.append(out.detach())
    assert torch.equal(outs[0], outs[1])
    for (name, a), b in zip(ref.named_parameters(), ckpt.parameters()):
        assert torch.equal(a.grad, b.grad), name
    with torch.no_grad():
        assert not torch.equal(ref(x, deterministic=False, generator=DropoutKey(12, 2, 1)),
                               outs[0])


def test_train_step_keys_by_step_and_micro_batch():
    seen = []

    def keyed(model, batch, key):
        seen.append(key)
        return model(batch).square().mean(), {}

    def plain(model, batch):
        return model(batch).square().mean(), {}

    model = torch.nn.Linear(3, 2)
    step = TrainStep(model, keyed, optim.adamw(model.parameters(), lr=1e-3), rng=7,
                     grad_accum_steps=2)
    batch = torch.randn(4, 3)
    step(batch)
    step(batch)
    assert seen == [DropoutKey(7, 0, 0), DropoutKey(7, 0, 1), DropoutKey(7, 1, 0),
                    DropoutKey(7, 1, 1)]
    assert step.rng.state_dict() == {"seed": 7, "step": 2}
    other = TrainStep(model, plain, optim.adamw(model.parameters(), lr=1e-3))
    assert torch.isfinite(other(batch)["loss"])
    assert other.rng.step == 1 and isinstance(other.rng, StepRng)


_SEEN = []


def _rng_kw(model, batch, *, rng=None):
    _SEEN.append(rng)
    return model(batch).sum(), {}


def _rng_named(model, batch, rng=None):
    _SEEN.append(rng)
    return model(batch).sum(), {}


def _weighted(model, batch, weight=1.0):
    _SEEN.append(weight)
    return weight * model(batch).sum(), {}


def _var_args(model, batch, *extra):
    _SEEN.append(extra[0] if extra else None)
    return model(batch).sum(), {}


@pytest.mark.parametrize("loss_fn, gets_key", [(_rng_kw, True), (_rng_named, True),
                                               (_weighted, False), (_var_args, True)])
def test_train_step_hands_the_key_only_to_a_loss_that_takes_one(loss_fn, gets_key):
    """A parameter named ``rng`` (keyword-only or not) gets the key by
    name; an unrelated defaulted third parameter keeps its default."""
    model = torch.nn.Linear(3, 2)
    step = TrainStep(model, loss_fn, optim.adamw(model.parameters(), lr=1e-3), rng=4)
    _SEEN.clear()
    step(torch.randn(2, 3))
    assert _SEEN == [DropoutKey(4, 0, 0) if gets_key else 1.0]


def _lm_loss(model, tokens, key):
    logits = model(tokens, deterministic=False, generator=key)
    return tg.cross_entropy_loss(logits[:, :-1], tokens[:, 1:]), {}


def _run(n_steps, tokens, state=None, seed=0, remat=False):
    st = create_train_state(_gpt2(remat, tie_word_embeddings=False), functools.partial(
        optim.adamw, lr=1e-2, clip_grad_norm=1.0), device="cpu", seed=seed)
    if state is not None:
        st.load_state_dict(state)
    step = TrainStep(st.model, _lm_loss, st.tx, rng=st.rng, grad_accum_steps=2)
    losses = [step(tokens[i])["loss"].item() for i in range(st.rng.step, n_steps)]
    return st, losses


def _tokens(n):
    rng = np.random.default_rng(3)
    return [torch.from_numpy(rng.integers(0, 256, (4, 24))) for _ in range(n)]


@pytest.mark.parametrize("remat", [False, True])
def test_resume_at_step_2_equals_the_unbroken_run(remat):
    tokens = _tokens(4)
    whole, want = _run(4, tokens, remat=remat)
    first, head = _run(2, tokens, remat=remat)
    saved = first.state_dict()
    assert saved["rng"] == {"seed": 0, "step": 2}
    resumed, tail = _run(4, tokens, state=saved, remat=remat)
    assert head + tail == want
    for (name, a), b in zip(whole.module.named_parameters(), resumed.module.parameters()):
        assert torch.equal(a, b), name
    # a different seed is a different run
    assert _run(1, tokens, seed=1)[1] != want[:1]


def test_rollback_target_through_the_portable_format(tmp_path):
    """``CheckpointManager`` keeps the step stream in ``rng/seed`` and
    ``rng/step``: a restore into a fresh state resumes the unbroken run."""
    tokens = _tokens(4)
    whole, want = _run(4, tokens)
    first, head = _run(2, tokens)
    mgr = CheckpointManager(str(tmp_path), save_every=2, keep=2)
    assert mgr.maybe_save(first.rng.step, first) is not None
    mgr.close()
    st = create_train_state(_gpt2(False, tie_word_embeddings=False), functools.partial(
        optim.adamw, lr=1e-2, clip_grad_norm=1.0), device="cpu", seed=9)
    step_no, _ = CheckpointManager(str(tmp_path)).restore_latest(st)
    assert step_no == 2 and st.rng.state_dict() == {"seed": 0, "step": 2}
    step = TrainStep(st.model, _lm_loss, st.tx, rng=st.rng, grad_accum_steps=2)
    tail = [step(tokens[i])["loss"].item() for i in range(2, 4)]
    assert head + tail == want
    for (name, a), b in zip(whole.module.named_parameters(), st.module.parameters()):
        assert torch.equal(a, b), name
