"""The 1-pod Trainer's 8-step psum runs (`llama3-8b` and `mamba2-2.7b`
reduced, f32 and bf16) from the reference's init against the
reference Trainer's, step by step: `tests/test_torch_train.py`'s
`test_training_reduces_loss` run, with its tolerances and fixtures
(in a file of its own so that the test workers share the suite's
longest runs).
"""
import pytest

from test_torch_train import (BF16_LOSS_RTOL, SSM_ARCH,  # noqa: F401
                              TRAIN_RTOL, _rel, built, from_reference, ref)
from repro_torch.data import pipeline
from repro_torch.train import optimizer
from repro_torch.train.loop import LoopConfig, Trainer


@pytest.mark.parametrize("arch,dtype", [
    pytest.param("llama3-8b", "float32", id="float32"),
    pytest.param("llama3-8b", "bfloat16", id="bfloat16"),
    pytest.param(SSM_ARCH, "float32", id=f"{SSM_ARCH}-float32"),
    pytest.param(SSM_ARCH, "bfloat16", id=f"{SSM_ARCH}-bfloat16")])
def test_psum_history_matches_reference(ref, built, from_reference, arch,
                                        dtype):
    """test_training_reduces_loss's run (lr 1e-3, warm-up 2, 8 steps)
    from the reference's init: every step's loss and grad norm against
    the reference Trainer's (f32 within 1e-4; bf16 within
    BF16_LOSS_RTOL)."""
    cfg, rcfg, rparams = built(arch, dtype)
    dcfg = dict(batch=4, seq=32, vocab=cfg.vocab)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=8)
    rtr = ref.loop.Trainer(rcfg, ref.compat.make_mesh((1,), ("data",)),
                           ref.pipeline.DataConfig(**dcfg),
                           ref.loop.LoopConfig(steps=8, sync="psum"),
                           opt=ref.opt.AdamWConfig(**kw))
    rtr.run(ref.jax.random.key(0))
    from_reference(rparams)
    tr = Trainer(cfg, 1, pipeline.DataConfig(**dcfg),
                 LoopConfig(steps=8, sync="psum"),
                 opt=optimizer.AdamWConfig(**kw), device="cpu")
    tr.run(0)
    tol = TRAIN_RTOL if dtype == "float32" else BF16_LOSS_RTOL
    assert [h["step"] for h in tr.history] == list(range(8))
    for got, want in zip(tr.history, rtr.history):
        assert _rel(got["loss"], want["loss"]) <= tol, (got, want)
    assert tr.events == rtr.events == []
