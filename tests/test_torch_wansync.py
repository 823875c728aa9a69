"""The port's WAN-scheduled gradient sync against the JAX reference's.

`wan_allreduce` (one process per pod): the reference runs once per
module in a subprocess with 4 forced host devices under
`jax.jit(shard_map(...))`, the port on 4 spawned gloo ranks on the CPU.
`wan_allreduce_batched` / `psum_allreduce_batched` (a leading pod dim):
the reference under `jax.jit` in this process. Each pod holds its own
random gradients, and the WANify schedule adds in the same order on
both sides.

Under `jax.jit` on the CPU, XLA fuses the decode's multiply into the
accumulation of an f32 sum, `acc + q * scale`, as one FMA; the batched
form keeps a bf16 leaf's sum in f32 across the phases, while the P2P
form rounds a bf16 leaf's decode and sum to bf16 at each phase, except
where the all-gather encodes the whole segment at 8 bits or fewer: XLA
drops the f32 -> bf16 -> f32 pair there and encodes the last sum
unrounded. The port computes the same (`wire_decode_add`,
`_leaf_wan_allreduce`), so every case is bit-equal on every rank.
`psum_allreduce` is bit-equal too: XLA's CPU all-reduce adds the pods
in pod order, a bf16 leaf in f32 with one rounding at the end, and the
port does the same; the f32 leaves are also held within (P - 1) units
in the last place of the largest sum of the pods' magnitudes (scaled
by 1/P) of the exact mean.
"""
import json
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

from repro_torch import compat
from repro_torch.core.wansync import (psum_allreduce, psum_allreduce_batched,
                                      wan_allreduce, wan_allreduce_batched)
from test_torch_migrate import (N_PODS, PLANS, SRC, _bf16_values, _flatten,
                                _nest, make_plan)

DEADLINE = 240          # seconds, each side
# (plan, compress, mean)
CASES = {"fixed_raw": ("fixed", False, True),
         "fixed": ("fixed", True, True),
         "fixed_sum": ("fixed", True, False),
         "mixed": ("mixed", True, True)}
DTYPES = {"b": "bfloat16"}


def _grads(shapes, seed):
    """{path: [P, ...] f32}: each pod's own gradients; bf16 leaves hold
    bf16 values."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, shape in shapes.items():
        a = rng.normal(size=(N_PODS,) + shape).astype(np.float32)
        out[path] = _bf16_values(a) if path in DTYPES else a
    return out


# axis 0 shorter than P x chunks (padded), ragged, a scalar, bf16
P2P_SHAPES = {"w": (12, 4), "v": (1001,), "s": (), "m": (3, 7, 5),
              "b": (37, 5)}


def _ulps(path, grads, mean: bool) -> float:
    """(P - 1) units in the last place of max_i sum_r |g_r[i]| in the
    leaf's dtype (bf16 keeps 8 significant bits, f32 24), scaled by 1/P
    for a mean."""
    mag = float(np.abs(grads[path].astype(np.float64)).sum(axis=0).max())
    bits = 8 if path in DTYPES else 24
    ulp = 2.0 ** (np.floor(np.log2(mag)) - (bits - 1))
    return (N_PODS - 1) * ulp / (N_PODS if mean else 1)




def _torch(a, path):
    return torch.from_numpy(a).to(getattr(torch, DTYPES.get(path,
                                                            "float32")))


def _sync_pod(rank, n_pods, grads):
    torch.set_num_threads(1)
    local = _nest({p: _torch(np.asarray(a[rank]), p)
                   for p, a in grads.items()})
    out = {}
    for name, (plan, compress, mean) in CASES.items():
        res = wan_allreduce(local, make_plan(PLANS[plan]),
                            compress=compress, mean=mean)
        out[name] = {p: t.float().numpy()
                     for p, t in _flatten(res).items()}
    out["psum"] = {p: t.float().numpy()
                   for p, t in _flatten(psum_allreduce(local)).items()}
    return out


@pytest.fixture(scope="module")
def grads():
    return _grads(P2P_SHAPES, seed=1)


@pytest.fixture(scope="module")
def port(grads):
    return compat.run_pods(_sync_pod, N_PODS, grads, timeout=DEADLINE)


_REFERENCE = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.compat import make_mesh, shard_map
    from repro.core.plan import WanPlan
    from repro.core.wansync import psum_allreduce, wan_allreduce

    spec = json.load(open(sys.argv[1]))
    arrays = np.load(sys.argv[2])
    mesh = make_mesh((4,), ("pod",))
    tree = {p: jnp.asarray(arrays[p]).astype(spec["dtypes"].get(p,
                                                                "float32"))
            for p in arrays.files}

    def plan_of(s):
        pol = s["bits_policy"]
        return WanPlan(n_pods=4, conns=tuple(map(tuple, s["conns"])),
                       pred_bw=tuple(map(tuple, s["pred_bw"])),
                       compress_bits=(8,) * 4,
                       bits_policy=None if pol is None else
                       tuple((float(t), int(b)) for t, b in pol))

    def run(f):
        def g(t):
            local = jax.tree.map(lambda x: x[0], t)
            return jax.tree.map(lambda x: x[None], f(local))
        sm = shard_map(g, mesh=mesh, in_specs=(P("pod"),),
                       out_specs=P("pod"), axis_names={"pod"},
                       check_vma=False)
        return jax.jit(sm)(tree)

    out = {}
    for name, (plan, compress, mean) in spec["cases"].items():
        res = run(lambda t, plan=plan_of(spec["plans"][plan]),
                  compress=compress, mean=mean: wan_allreduce(
                      t, plan, compress=compress, mean=mean))
        for p, v in res.items():
            out[name + ":" + p] = np.asarray(v.astype(jnp.float32))
    res = run(psum_allreduce)
    for p, v in res.items():
        out["psum:" + p] = np.asarray(v.astype(jnp.float32))
    np.savez(sys.argv[3], **out)
    print("REFERENCE_OK")
""")


@pytest.fixture(scope="module")
def reference(grads, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("wansync_ref")
    (tmp / "spec.json").write_text(json.dumps(
        {"cases": CASES, "plans": PLANS, "dtypes": DTYPES}))
    np.savez(tmp / "in.npz", **grads)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REFERENCE,
                        str(tmp / "spec.json"), str(tmp / "in.npz"),
                        str(tmp / "out.npz")], capture_output=True,
                       text=True, env=env, timeout=DEADLINE)
    assert "REFERENCE_OK" in r.stdout, r.stdout + r.stderr
    with np.load(tmp / "out.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("rank", range(N_PODS))
@pytest.mark.parametrize("case", list(CASES))
def test_wan_allreduce_matches_reference(port, reference, case, rank):
    for path in P2P_SHAPES:
        want = reference[f"{case}:{path}"][rank]
        got = port[rank][case][path]
        assert got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.mark.parametrize("rank", range(N_PODS))
def test_psum_allreduce_matches_reference(port, reference, grads, rank):
    for path, a in grads.items():
        np.testing.assert_array_equal(port[rank]["psum"][path],
                                      reference[f"psum:{path}"][rank],
                                      err_msg=path)
        if path not in DTYPES:      # and the mean of the pods' values
            tol = _ulps(path, grads, mean=True)
            np.testing.assert_allclose(port[rank]["psum"][path],
                                       a.astype(np.float64).mean(axis=0),
                                       rtol=0, atol=tol, err_msg=path)


def test_uncompressed_sync_is_the_mean(port, grads):
    for r in range(N_PODS):
        for path, a in grads.items():
            if path in DTYPES:
                continue
            np.testing.assert_allclose(port[r]["fixed_raw"][path],
                                       a.astype(np.float64).mean(axis=0),
                                       rtol=1e-5, atol=1e-6, err_msg=path)


# ----------------------------------------------------------------------
# batched formulation, in this process
# ----------------------------------------------------------------------
# axis 1 split by the chunks (16 % 8 == 0), not split (5), 1-D, bf16
BATCHED_SHAPES = {"w": (16, 3), "r": (5, 3), "v": (), "b": (8, 6),
                  "e": (32, 2, 9)}


@pytest.fixture(scope="module")
def batched():
    """The reference's batched functions, jitted, and the inputs."""
    import jax
    import jax.numpy as jnp

    from repro.core.plan import WanPlan as RefPlan
    from repro.core.wansync import (psum_allreduce_batched as ref_psum,
                                    wan_allreduce_batched as ref_wan)
    grads = _grads(BATCHED_SHAPES, seed=2)

    def ref_plan(spec):
        pol = spec["bits_policy"]
        return RefPlan(n_pods=N_PODS,
                       conns=tuple(tuple(r) for r in spec["conns"]),
                       pred_bw=tuple(tuple(r) for r in spec["pred_bw"]),
                       compress_bits=(8,) * N_PODS,
                       bits_policy=None if pol is None
                       else tuple((float(t), int(b)) for t, b in pol))

    jtree = {p: jnp.asarray(a).astype(DTYPES.get(p, "float32"))
             for p, a in grads.items()}
    return types.SimpleNamespace(jax=jax, jnp=jnp, wan=ref_wan,
                                 psum=ref_psum, plan=ref_plan, grads=grads,
                                 jtree=jtree)


def _f32(tree):
    return {p: np.asarray(v).astype(np.float32) if not isinstance(
        v, torch.Tensor) else v.float().numpy() for p, v in tree.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_wan_allreduce_batched_matches_reference(batched, case):
    plan, compress, mean = CASES[case]
    want = batched.jax.jit(lambda t: batched.wan(
        t, batched.plan(PLANS[plan]), compress=compress, mean=mean))(
        batched.jtree)
    tree = {p: _torch(a, p) for p, a in batched.grads.items()}
    got = wan_allreduce_batched(tree, make_plan(PLANS[plan]),
                                compress=compress, mean=mean)
    for path in tree:
        assert got[path].dtype == tree[path].dtype
        np.testing.assert_array_equal(_f32(got)[path], _f32(want)[path],
                                      err_msg=path)
    for path, a in batched.grads.items():      # the inputs stay as they were
        np.testing.assert_array_equal(tree[path].float().numpy(), a)


@pytest.mark.parametrize("mean", [True, False])
def test_psum_allreduce_batched_matches_reference(batched, mean):
    want = batched.jax.jit(lambda t: batched.psum(t, N_PODS, mean=mean))(
        batched.jtree)
    tree = {p: _torch(a, p) for p, a in batched.grads.items()}
    got = psum_allreduce_batched(tree, N_PODS, mean=mean)
    for path in tree:
        assert tuple(got[path].shape) == tuple(tree[path].shape)
        np.testing.assert_array_equal(_f32(got)[path], _f32(want)[path],
                                      err_msg=path)


def test_batched_one_pod_plan_is_the_identity():
    plan = make_plan(PLANS["fixed"]).__class__(
        n_pods=1, conns=((1,),), pred_bw=((1e3,),), compress_bits=(8,))
    tree = {"w": torch.ones((1, 3))}
    assert wan_allreduce_batched(tree, plan) is tree
