"""The port's checkpoints (`repro_torch.checkpoint.ckpt`) in the JAX
package's on-disk layout: a checkpoint written by either package
restores in the other, bit for bit, weights and optimizer state, bf16
leaves included; and the port never imports `ml_dtypes` (the card
machine has none).

The trees are the reference's `{"p": params, "o": opt_state}` of
`reduced(get_config("qwen3-4b"))` (blocks stacked [L, ...]), the
moments in bf16 (`AdamWConfig.state_dtype`), the step an int32 scalar.
"""
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.compat import tree_map
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.data.pipeline import DataConfig
from repro_torch.train.loop import LoopConfig, Trainer

SRC = str(Path(__file__).resolve().parents[1] / "src")
ARCH = "qwen3-4b"


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp

    from repro import compat
    from repro.checkpoint import ckpt as ref_ckpt
    from repro.configs import get_config as ref_config
    from repro.configs.base import reduced as ref_reduced
    from repro.data.pipeline import DataConfig as RefDataConfig
    from repro.models import registry as ref_registry
    from repro.train import loop as ref_loop
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, compat=compat, ckpt=ref_ckpt,
        config=ref_config, reduced=ref_reduced, DataConfig=RefDataConfig,
        registry=ref_registry, loop=ref_loop)


@pytest.fixture(scope="module")
def ref_state(ref):
    """The reference's tree: f32 parameters, bf16 moments drawn from a
    seed, step 7."""
    cfg = ref.reduced(ref.config(ARCH))
    params = ref.registry.init_params(cfg, ref.jax.random.key(1))
    rng = np.random.default_rng(0)

    def moment(p):
        return ref.jnp.asarray(rng.standard_normal(p.shape).astype(
            np.float32) * 1e-3).astype(ref.jnp.bfloat16)
    return {"p": params,
            "o": {"m": ref.jax.tree.map(moment, params),
                  "v": ref.jax.tree.map(moment, params),
                  "step": ref.jnp.int32(7)}}


def _torch_tree(ref, tree):
    """The reference's tree as torch tensors, bf16 through uint16 (the
    test's own conversion, independent of the module under test)."""
    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.uint16).astype(np.int32)).to(
                torch.int16).view(torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return ref.jax.tree.map(conv, tree)


def _bits(x) -> np.ndarray:
    """Raw bits of a leaf (torch or jax), for exact comparison."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}[{k!r}]"))
        return out
    return {prefix: tree}


def _assert_same(got, want):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for k in want:
        g, w = _bits(got[k]), _bits(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_layout_equals_the_reference(ref, ref_state, tmp_path):
    """The same tree written by both: equal manifests, the same npz
    members holding the same bytes."""
    ref.ckpt.save(str(tmp_path / "ref"), 5, ref_state)
    ckpt.save(str(tmp_path / "port"), 5, _torch_tree(ref, ref_state))
    dirs = [tmp_path / side / "step_00000005" for side in ("ref", "port")]
    manifests = [json.loads((d / "manifest.json").read_text())
                 for d in dirs]
    assert manifests[0] == manifests[1]
    assert "['o']['m']['blocks']['attn']['q_scale']" in \
        manifests[0]["leaves"]
    assert manifests[0]["dtypes"]["['o']['m']['embed']"] == "bfloat16"
    assert manifests[0]["dtypes"]["['o']['step']"] == "int32"
    with np.load(dirs[0] / "shard_0.npz") as a, \
            np.load(dirs[1] / "shard_0.npz") as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_port_checkpoint_restores_in_reference(ref, ref_state, tmp_path):
    ckpt.save(str(tmp_path), 3, _torch_tree(ref, ref_state))
    assert ref.ckpt.latest_step(str(tmp_path)) == 3
    _assert_same(ref.ckpt.restore(str(tmp_path), ref_state), ref_state)


def test_reference_checkpoint_restores_in_port(ref, ref_state, tmp_path):
    ref.ckpt.save(str(tmp_path), 4, ref_state, async_=True).join()
    assert ckpt.latest_step(str(tmp_path)) == 4
    like = tree_map(lambda t: t.to("meta"), _torch_tree(ref, ref_state))
    got = ckpt.restore(str(tmp_path), like)
    assert got["o"]["step"].shape == () and \
        got["o"]["step"].dtype == torch.int32
    _assert_same(got, ref_state)


def test_restore_casts_to_the_like_dtype(ref, ref_state, tmp_path):
    ckpt.save(str(tmp_path), 1, _torch_tree(ref, ref_state))
    like = tree_map(lambda t: t.to("meta", torch.float32),
                    _torch_tree(ref, ref_state)["o"])
    got = ckpt.restore(str(tmp_path), {"o": like})["o"]
    want = np.asarray(ref_state["o"]["m"]["embed"].astype("float32"))
    assert got["m"]["embed"].dtype == torch.float32
    np.testing.assert_array_equal(got["m"]["embed"].numpy(), want)


def test_shards_split_as_the_reference(ref, ref_state, tmp_path,
                                       monkeypatch):
    """A new shard every _SHARD_BYTES (here 64 KiB): the same shards
    holding the same leaves on both sides."""
    monkeypatch.setattr(ref.ckpt, "_SHARD_BYTES", 64 << 10)
    monkeypatch.setattr(ckpt, "_SHARD_BYTES", 64 << 10)
    ref.ckpt.save(str(tmp_path / "ref"), 2, ref_state)
    ckpt.save(str(tmp_path / "port"), 2, _torch_tree(ref, ref_state))
    m = [json.loads((tmp_path / s / "step_00000002" / "manifest.json")
                    .read_text()) for s in ("ref", "port")]
    assert m[0] == m[1] and len(m[0]["shards"]) > 2
    for name in m[0]["shards"]:
        with np.load(tmp_path / "ref" / "step_00000002" / name) as a, \
                np.load(tmp_path / "port" / "step_00000002" / name) as b:
            assert a.files == b.files
    _assert_same(ckpt.restore(str(tmp_path / "ref"), tree_map(
        lambda t: t.to("meta"), _torch_tree(ref, ref_state))), ref_state)


def test_latest_step_skips_incomplete_writes(tmp_path):
    tree = {"w": torch.arange(6.0).reshape(2, 3)}
    ckpt.save(str(tmp_path), 2, tree)
    partial = tmp_path / "step_00000009"
    partial.mkdir()
    (partial / "manifest.json").write_text(json.dumps({"step": 9}))
    (tmp_path / "step_00000011").mkdir()
    assert ckpt.latest_step(str(tmp_path)) == 2
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), tree)
    # the leaves are host copies when save returns: an in-place update
    # right after does not reach the files
    writer = ckpt.save(str(tmp_path), 3, tree, async_=True)
    tree["w"].add_(100.0)
    writer.join()
    np.testing.assert_array_equal(
        ckpt.restore(str(tmp_path), tree)["w"].numpy(),
        np.arange(6.0).reshape(2, 3))


def test_bf16_round_trip_without_ml_dtypes(tmp_path):
    """bf16 goes through uint16 and a torch view: saving and restoring a
    bf16 tree imports no ml_dtypes."""
    code = (
        "import sys, torch\n"
        "from repro_torch.checkpoint import ckpt\n"
        "t = {'a': torch.randn(5, 3).bfloat16(), 'b': torch.ones(2)}\n"
        f"ckpt.save({str(tmp_path)!r}, 1, t)\n"
        f"r = ckpt.restore({str(tmp_path)!r}, t)\n"
        "assert torch.equal(r['a'], t['a']) and r['a'].dtype == "
        "torch.bfloat16\n"
        "assert 'ml_dtypes' not in sys.modules, 'ml_dtypes imported'\n"
        "print('OK')\n")
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr


def _ref_trainer(ref, ckpt_dir, steps):
    cfg = ref.reduced(ref.config(ARCH))
    return ref.loop.Trainer(
        cfg, ref.compat.make_mesh((1,), ("data",)),
        ref.DataConfig(batch=4, seq=32, vocab=cfg.vocab),
        ref.loop.LoopConfig(steps=steps, ckpt_dir=str(ckpt_dir),
                            ckpt_every=3, sync="psum"))


def _port_trainer(ckpt_dir, steps):
    cfg = reduced(get_config(ARCH))
    return Trainer(cfg, 1, DataConfig(batch=4, seq=32, vocab=cfg.vocab),
                   LoopConfig(steps=steps, ckpt_dir=str(ckpt_dir),
                              ckpt_every=3, sync="psum"), device="cpu")


def test_trainers_resume_from_each_other(ref, tmp_path):
    """The reference's Trainer writes step 3; the port's restores it bit
    for bit into its stacked tree, trains on and writes step 6;
    the reference's restores that bit for bit and trains on."""
    rparams, rstate = _ref_trainer(ref, tmp_path, 3).run(
        ref.jax.random.key(0))
    params, state, start = _port_trainer(tmp_path, 6).restore_or_init(0)
    assert start == 3
    _assert_same({"p": params, "o": state}, {"p": rparams, "o": rstate})
    tr = _port_trainer(tmp_path, 6)
    params, state = tr.run(0)
    assert tr.events == ["restored step 3"]
    assert [h["step"] for h in tr.history] == [3, 4, 5]
    _assert_same(ref.ckpt.restore(str(tmp_path), {"p": rparams,
                                                  "o": rstate}, step=6),
                 {"p": params, "o": state})
    rtr = _ref_trainer(ref, tmp_path, 7)
    rtr.run(ref.jax.random.key(0))
    assert rtr.events == ["restored step 6"]
    assert [h["step"] for h in rtr.history] == [6]
