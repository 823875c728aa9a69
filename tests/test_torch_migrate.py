"""The port's `kv_migrate` against the JAX reference's, on 4 pods.

The reference runs once per module in a subprocess with 4 forced host
devices, under `jax.jit(shard_map(...))` over a ("pod",) mesh, as
`tests/test_system.py` runs `wan_allreduce`. The port runs once per
module on 4 spawned gloo ranks on the CPU (`compat.run_pods`), where
the wire codec takes its plain versions. Pod r's input is x * (r + 1),
so keeping or replacing a copy shows. Every case is bit-equal on every
pod: no tolerance.

Cases: the fixed 4-pod plan of `tests/test_system.py` (8 chunks at 8
bits on every offset) with and without compression; a plan whose bits
policy gives 4, 8 and 16 bits on the three offsets with 4, 1 and 2
chunks, from pod 2; and caches of per-layer dicts from a reduced
`mamba2-2.7b` and a reduced `llama3-8b` (the dense family's bf16 k / v
[L,B,KV,S,D], the cache WANify's migration plans move between pods),
which the port stacks into the reference's leaves before it migrates
(migrated per layer, the scales differ).
"""
import importlib.util
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from repro_torch import compat
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.control.schedule import offset_schedule
from repro_torch.core.plan import WanPlan
from repro_torch.models import registry, ssm
from repro_torch.models.transformer import stack_cache
from repro_torch.obs.spans import SpanTracer
from repro_torch.serve.engine import kv_migrate
from torch_pods import _failing_pod, _sleeping_pod

N_PODS = 4
DEADLINE = 240          # seconds, each side
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _plan_spec(by_offset, bits_policy=None):
    """conns / pred_bw of a 4-pod plan from a function of (i, j)."""
    conns = [[by_offset(i, j)[0] for j in range(N_PODS)]
             for i in range(N_PODS)]
    bw = [[by_offset(i, j)[1] for j in range(N_PODS)]
          for i in range(N_PODS)]
    return {"conns": conns, "pred_bw": bw, "bits_policy": bits_policy}


PLANS = {
    # tests/test_system.py:73-79: 8 chunks at 8 bits on every offset
    "fixed": _plan_spec(lambda i, j: (6, 150.0) if abs(i - j) % 4 > 1
                        else (2, 900.0)),
    # offset 1: 3 conns (4 chunks), 100 Mbps (4 bits); offset 2: 1 conn,
    # 400 Mbps (8 bits); offset 3: 2 conns, 1000 Mbps (16 bits)
    "mixed": _plan_spec(
        lambda i, j: {0: (1, 5000.0), 1: (3, 100.0), 2: (1, 400.0),
                      3: (2, 1000.0)}[(j - i) % 4],
        bits_policy=[[200.0, 4], [600.0, 8], [1500.0, 16],
                     [float("inf"), 32]]),
}
CASES = {"fixed": ("tree", "fixed", 0, True),
         "fixed_raw": ("tree", "fixed", 0, False),
         "mixed": ("tree", "mixed", 2, True),
         "mamba": ("mamba", "fixed", 0, True),
         "dense": ("dense", "fixed", 0, True)}
LAYERED = ("mamba", "dense")      # trees in the port's per-layer layout


def make_plan(spec) -> WanPlan:
    pol = spec["bits_policy"]
    return WanPlan(n_pods=N_PODS,
                   conns=tuple(tuple(r) for r in spec["conns"]),
                   pred_bw=tuple(tuple(r) for r in spec["pred_bw"]),
                   compress_bits=(8,) * N_PODS,
                   bits_policy=None if pol is None
                   else tuple((float(t), int(b)) for t, b in pol))


def _bf16_values(a: np.ndarray) -> np.ndarray:
    """f32 values that bf16 holds exactly."""
    return torch.from_numpy(a).bfloat16().float().numpy()


def _inputs():
    """Flat {path: f32 array} per tree, and {path: dtype}."""
    rng = np.random.default_rng(0)
    tree = {"w": np.arange(48.0, dtype=np.float32).reshape(12, 4) / 7.0,
            "v": rng.normal(size=1001).astype(np.float32),
            "s": np.array(2.5, np.float32),
            "b": _bf16_values(rng.normal(size=(37, 5)).astype(np.float32))}
    cfg = reduced(get_config("mamba2-2.7b"))
    spec = ssm.ssm_cache_spec(cfg, 2, torch.bfloat16)
    L = cfg.n_layers
    mamba = {"blocks/conv": _bf16_values(rng.normal(
                 size=(L,) + spec["conv"][0]).astype(np.float32)),
             "blocks/state": rng.normal(
                 size=(L,) + spec["state"][0]).astype(np.float32)}
    spec = registry.cache_spec(reduced(get_config("llama3-8b")), 2, 24)
    dense = {f"blocks/{k}": _bf16_values(rng.normal(
        size=(len(spec["blocks"]),) + spec["blocks"][0][k][0]).astype(
        np.float32)) for k in ("k", "v")}
    dtypes = {"b": "bfloat16", "blocks/conv": "bfloat16",
              "blocks/k": "bfloat16", "blocks/v": "bfloat16"}
    return {"tree": tree, "mamba": mamba, "dense": dense}, dtypes


def _nest(flat):
    out = {}
    for path, v in flat.items():
        *head, last = path.split("/")
        d = out
        for k in head:
            d = d.setdefault(k, {})
        d[last] = v
    return out


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


# ----------------------------------------------------------------------
# the port: 4 gloo ranks
# ----------------------------------------------------------------------
def _local(flat, dtypes, rank):
    """Pod `rank`'s tensors: x * (rank + 1) in f32, then its dtype."""
    return {p: (torch.from_numpy(a) * (rank + 1.0)).to(
        getattr(torch, dtypes.get(p, "float32"))) for p, a in flat.items()}


def _numpy(flat):
    return {p: t.float().numpy() for p, t in flat.items()}


def _migrate_pod(rank, n_pods, trees, dtypes):
    torch.set_num_threads(1)
    sent = {}                   # bytes handed to ppermute, by offset
    ppermute = compat.ppermute

    def counting(x, offset, group=None):
        sent[offset] = sent.get(offset, 0) + x.numel() * x.element_size()
        return ppermute(x, offset, group)

    compat.ppermute = counting  # this pod's process only
    out = {}
    for name, (tree, plan, src, compress) in CASES.items():
        local = _nest(_local(trees[tree], dtypes, rank))
        if tree in LAYERED:     # the port's model layout: one dict per layer
            L = len(next(iter(local["blocks"].values())))
            local = {"blocks": [{k: v[i].clone() for k, v in
                                 local["blocks"].items()} for i in range(L)]}
        sent.clear()
        tracer = SpanTracer()
        moved = kv_migrate(local, make_plan(PLANS[plan]), src,
                           compress=compress, tracer=tracer)
        out[name + "/stats"] = {
            "sent": dict(sent),
            "span_offsets": [s["attrs"]["offset"] for s in tracer.spans],
            "span_s": [s["dur_s"] for s in tracer.spans]}
        if tree in LAYERED:
            assert isinstance(moved["blocks"], list)
            moved = stack_cache(moved)
        if tree == "mamba":
            # the same tensors as separate per-layer leaves
            per_layer = kv_migrate(tuple(local["blocks"]),
                                   make_plan(PLANS[plan]), src)
            out["mamba_per_layer"] = {"blocks/state": torch.stack(
                [b["state"] for b in per_layer]).numpy()}
        out[name] = _numpy(_flatten(moved))
    two_pods = WanPlan(n_pods=2, conns=((1, 2), (2, 1)),
                       pred_bw=((1e3, 100.0), (100.0, 1e3)),
                       compress_bits=(8, 8))
    try:
        kv_migrate({"w": torch.ones(3)}, two_pods, 0)
        out["wrong_size"] = "no error"
    except ValueError as e:
        out["wrong_size"] = str(e)
    return out


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def port(inputs):
    trees, dtypes = inputs
    return compat.run_pods(_migrate_pod, N_PODS, trees, dtypes,
                           timeout=DEADLINE)


# ----------------------------------------------------------------------
# the reference: one subprocess, jit(shard_map) on 4 host devices
# ----------------------------------------------------------------------
_REFERENCE = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.compat import make_mesh, shard_map
    from repro.core.plan import WanPlan
    from repro.serve.engine import kv_migrate

    spec = json.load(open(sys.argv[1]))
    arrays = np.load(sys.argv[2])
    mesh = make_mesh((4,), ("pod",))

    def plan_of(s):
        pol = s["bits_policy"]
        return WanPlan(n_pods=4, conns=tuple(map(tuple, s["conns"])),
                       pred_bw=tuple(map(tuple, s["pred_bw"])),
                       compress_bits=(8,) * 4,
                       bits_policy=None if pol is None else
                       tuple((float(t), int(b)) for t, b in pol))

    out = {}
    for name, (tree, plan, src, compress) in spec["cases"].items():
        paths = spec["paths"][tree]
        leaves = {p: jnp.asarray(arrays[tree + ":" + p]).astype(
            spec["dtypes"].get(p, "float32")) for p in paths}

        def f(t, plan=plan_of(spec["plans"][plan]), src=src,
              compress=compress):
            r = jax.lax.axis_index("pod").astype(jnp.float32)
            local = jax.tree.map(lambda x: (x.astype(jnp.float32) *
                                            (r + 1.0)).astype(x.dtype), t)
            moved = kv_migrate(local, plan, src, compress=compress)
            return jax.tree.map(lambda x: x[None], moved)

        # nest "blocks/conv" paths as the reference's cache tree
        nested = {}
        for p, v in leaves.items():
            *head, last = p.split("/")
            d = nested
            for k in head:
                d = d.setdefault(k, {})
            d[last] = v
        sm = shard_map(f, mesh=mesh, in_specs=(P(),), out_specs=P("pod"),
                       axis_names={"pod"}, check_vma=False)
        res = jax.jit(sm)(nested)
        for p in paths:
            v = res
            for k in p.split("/"):
                v = v[k]
            out[name + ":" + p] = np.asarray(v.astype(jnp.float32))
    np.savez(sys.argv[3], **out)
    print("REFERENCE_OK")
""")


@pytest.fixture(scope="module")
def reference(inputs, tmp_path_factory):
    trees, dtypes = inputs
    tmp = tmp_path_factory.mktemp("migrate_ref")
    spec = {"cases": CASES, "plans": PLANS, "dtypes": dtypes,
            "paths": {k: list(v) for k, v in trees.items()}}
    (tmp / "spec.json").write_text(json.dumps(spec))
    np.savez(tmp / "in.npz", **{f"{t}:{p}": a for t, flat in trees.items()
                                for p, a in flat.items()})
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REFERENCE, str(tmp /
                        "spec.json"), str(tmp / "in.npz"),
                        str(tmp / "out.npz")], capture_output=True,
                       text=True, env=env, timeout=DEADLINE)
    assert "REFERENCE_OK" in r.stdout, r.stdout + r.stderr
    with np.load(tmp / "out.npz") as z:
        return {k: z[k] for k in z.files}


# ----------------------------------------------------------------------
@pytest.mark.parametrize("rank", range(N_PODS))
@pytest.mark.parametrize("case", list(CASES))
def test_kv_migrate_matches_reference(port, reference, inputs, case, rank):
    tree = CASES[case][0]
    for path in inputs[0][tree]:
        want = reference[f"{case}:{path}"][rank]
        got = port[rank][case][path]
        assert got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.mark.parametrize("case", list(CASES))
def test_src_pod_keeps_its_cache_and_receivers_replace(port, inputs, case):
    """The source keeps x * (src + 1) unchanged; without compression
    every pod ends with exactly that."""
    tree, _, src, compress = CASES[case]
    for path, a in inputs[0][tree].items():
        src_val = port[src][case][path]
        want = (torch.from_numpy(a) * (src + 1.0)).to(getattr(
            torch, inputs[1].get(path, "float32"))).float().numpy()
        np.testing.assert_array_equal(src_val, want)
        for r in range(N_PODS):
            if not compress:
                np.testing.assert_array_equal(port[r][case][path], want)
            elif r != src and path in ("v", "blocks/state"):
                assert not np.array_equal(port[r][case][path], want)


def test_per_layer_leaves_would_give_other_scales(port, reference):
    """Why the port stacks its per-layer cache: migrated as separate
    per-layer leaves, a receiving pod's state differs from the
    reference's (a segment's scale depends on what it holds)."""
    for r in range(1, N_PODS):
        got = port[r]["mamba_per_layer"]["blocks/state"]
        assert not np.array_equal(got, reference["mamba:blocks/state"][r])
        np.testing.assert_array_equal(port[r]["mamba"]["blocks/state"],
                                      reference["mamba:blocks/state"][r])


def _chip_smoke():
    """`chip_smoke.py` as a module: its wire-byte count is what the chip
    run reports."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), "..",
                                   "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("case", list(CASES))
def test_stats_count_the_wire_bytes(port, inputs, case):
    """The bytes each pod handed to `ppermute` in each phase (the
    zero-padded payload at the phase's bits, int8 below 16, plus a
    4-byte scale per part) are what `chip_smoke.wire_bytes` works out
    from the schedule and the leaves; the tracer holds one span per
    leaf and phase."""
    tree, plan, _, compress = CASES[case]
    plan = make_plan(PLANS[plan])
    sched = offset_schedule(plan)
    leaves = list(_local(inputs[0][tree], inputs[1], 0).values())
    want = _chip_smoke().wire_bytes(leaves, plan, compress)
    for r in range(N_PODS):
        stats = port[r][case + "/stats"]
        assert [stats["sent"][ph["offset"]] for ph in sched] == want
        assert stats["span_offsets"] == [ph["offset"] for ph in sched] * \
            len(leaves)
        assert all(t > 0 for t in stats["span_s"])


def test_group_size_must_match_the_plan(port):
    for r in range(N_PODS):
        assert "2 pods, the group 4" in port[r]["wrong_size"]


def test_one_pod_plan_is_the_identity():
    plan = WanPlan(n_pods=1, conns=((1,),), pred_bw=((1e3,),),
                   compress_bits=(8,))
    cache = {"w": torch.ones(3)}
    assert kv_migrate(cache, plan, 0) is cache


# ----------------------------------------------------------------------
# the pod launcher: a failing or hanging pod fails the call, in time
# (the pod functions live in tests/torch_pods.py, which a spawned pod
# imports in well under the deadline; this module takes seconds)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("fn,match", [(_failing_pod, "pod 1 failed"),
                                      (_sleeping_pod, "timed out")],
                         ids=["raises", "hangs"])
def test_run_pods_fails_a_call_whose_pod_fails(fn, match):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=match) as err:
        compat.run_pods(fn, 2, timeout=8)
    assert time.monotonic() - t0 < 40
    if fn is _failing_pod:
        assert "pod one gives up" in str(err.value)
