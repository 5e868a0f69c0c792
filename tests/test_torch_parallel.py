"""The port's parallel slice (ray_tpu_torch.parallel, ring attention and
the sharded train step) against the JAX package's, on the CPU.

The JAX side runs in this process on the conftest's 8-device CPU mesh,
over ``jax.devices()[:4]`` for each mesh shape (as
tests/test_ops_parallel.py does). The port's side runs on 4 gloo ranks,
spawned once for the whole file (``_spawn``; the ranks run
tests/torch_parallel_cases.py, which imports no JAX) while the JAX side
computes. Inputs are numpy arrays from seeds; params are JAX's, carried
across by interop.params_from_jax.

Tolerances: ring attention 2e-5 (test_ops_parallel.py's), its gradients
1e-5 of each one's largest |value|; the pipeline 1e-5; train steps (f32,
2 steps): loss and grad norm 1e-5 relative, every parameter leaf within
1e-4 of its largest |value| (AdamW's eps is 1e-6, as in
test_torch_train.py). Expert parallelism (tiny_moe on (data 1, expert
4)) compares the routing of every step exactly before the values.
"""

import concurrent.futures
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

import torch_parallel_cases as cases
from ray_tpu.models import transformer as J
from ray_tpu.ops import moe as JM
from ray_tpu.ops import ring_attention_sharded as jring
from ray_tpu.ops.optim import FusedClipAdamW as JFused
from ray_tpu.parallel import MeshConfig as JMesh
from ray_tpu.parallel import batch_sharding as jbatch_sharding
from ray_tpu.parallel import fsdp_spec_for as jfsdp_spec_for
from ray_tpu.parallel import infer_param_specs as jinfer
from ray_tpu.parallel import pipelined_apply as jpipelined
from ray_tpu.parallel import replicated as jreplicated
from ray_tpu.parallel import shard_params as jshard
from ray_tpu.parallel.multislice import build_multislice_mesh as jmultislice
from ray_tpu.parallel.multislice import dcn_allreduce_axes as jallreduce_axes
from ray_tpu.parallel.multislice import detect_num_slices as jdetect
from ray_tpu.parallel.multislice import multislice_batch_axes as jbatch_axes
from ray_tpu_torch import parallel
from ray_tpu_torch.models import transformer as T
from ray_tpu_torch.parallel import _spawn

DEVICES = 4


def _jmesh(kind):
    devices = jax.devices()[:DEVICES]
    if kind == "multislice":
        return jmultislice(2, JMesh(tensor=2), devices=devices)
    return JMesh(**kind).build(devices)


@functools.lru_cache
def _jax_params(jc):
    return jax.device_get(jax.jit(lambda key: J.init_params(key, jc))(jax.random.PRNGKey(0)))


def _tokens(b, t, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (b, t))


def _qkv(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, 128, 2, 16)).astype(np.float32) for _ in range(3)]


TRAIN = {  # name: (mesh, optimizer, overrides of tiny(), masked batch)
    "dp2_tp2": ({"data": 2, "tensor": 2}, "fused", {}, False),
    "fsdp4": ({"data": 1, "fsdp": 4}, "chain", {}, False),
    "multislice": ("multislice", "sgd", {}, False),
    "seq2_tp2": ({"data": 1, "sequence": 2, "tensor": 2}, "sgd", {}, False),
    "llama_fsdp2_tp2": ({"data": 1, "fsdp": 2, "tensor": 2}, "chain",
                        {"arch": "llama", "n_kv_heads": 2, "loss_chunk": 24}, True),
    # tiny_moe(), the counterpart of tests/test_moe.py:80's step.
    "moe_ep4": ({"data": 1, "expert": 4}, "sgd",
                {"arch": "llama", "n_experts": 4, "expert_top_k": 2, "remat": True}, False),
}


def _train_config(name):
    return dataclasses.replace(J.tiny(dtype="float32"), **TRAIN[name][2])


def _jax_optimizer(kind):
    if kind == "fused":
        return JFused(learning_rate=1e-3, eps=1e-3, weight_decay=0.1, clip_norm=1.0)
    if kind == "chain":
        return optax.chain(optax.clip_by_global_norm(1.0),
                           optax.adamw(1e-3, eps=1e-6, weight_decay=0.1))
    return optax.sgd(1e-2)


def _jax_routing(params, jc, inputs):
    """The experts keeping each token ([n, g, E] bool, one per MoE layer)
    in ray_tpu's forward of ``inputs``, seen at each moe_swiglu call (its
    routing's first lines, as written there)."""
    c = dataclasses.replace(jc, scan_layers=False, remat=False)
    kept, orig = [], JM.moe_swiglu

    def spy(x, router_w, *w, top_k, capacity_factor=1.25, group_size=1024, **kw):
        B, S, D = x.shape
        g = JM._group_size(B * S, group_size)
        logits = jnp.einsum("ngd,de->nge", x.reshape(B * S // g, g, D).astype(jnp.float32),
                            router_w.astype(jnp.float32))
        C = JM.expert_capacity(g, router_w.shape[-1], top_k, capacity_factor)
        dispatch = jax.vmap(lambda lg: JM.topk_dispatch(lg, top_k, C)[0])(logits)
        kept.append(np.asarray(dispatch.sum(-1) > 0))
        return orig(x, router_w, *w, top_k=top_k, capacity_factor=capacity_factor,
                    group_size=group_size, **kw)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(JM, "moe_swiglu", spy)
        J.forward(params, jnp.asarray(inputs), c)
    return kept


def jax_train(jc, params, tokens, mesh_kind, opt_kind, mask=None, steps=2):
    """ray_tpu's make_train_step on the same mesh shape, from ``params``:
    each step's metrics, the final params, for an MoE model the routing
    before each step (``_jax_routing``), and the placed w_gate's spec."""
    mesh = _jmesh(mesh_kind)
    opt = _jax_optimizer(opt_kind)
    placed, _ = jshard(params, mesh, J.partition_specs(jc))
    state = {"params": placed,
             "opt_state": jax.device_put(opt.init(placed), jreplicated(mesh)),
             "step": jax.device_put(jnp.zeros((), jnp.int32), jreplicated(mesh))}
    batch = {"tokens": jnp.asarray(tokens)}
    if mask is not None:
        batch["mask"] = jnp.asarray(mask)
    if mesh_kind == "multislice":
        batch = {"tokens": jax.device_put(batch["tokens"],
                                          NamedSharding(mesh, JP(jbatch_axes(mesh))))}
    step = jax.jit(J.make_train_step(jc, opt, mesh=mesh))
    metrics, kept = [], []
    for _ in range(steps):
        if jc.n_experts > 0:
            kept.append(_jax_routing(jax.device_get(state["params"]), jc, tokens[:, :-1]))
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    mlp = state["params"]["layers"]["mlp"]
    return types.SimpleNamespace(
        metrics=metrics, params=jax.device_get(state["params"]), kept=kept,
        w_gate_spec=tuple(mlp["w_gate"].sharding.spec) if jc.n_experts > 0 else None)


def _pairs(jtree, ttree, path=()):
    for key, jv in jtree.items():
        if isinstance(jv, dict):
            yield from _pairs(jv, ttree[key], path + (key,))
        else:
            yield "/".join(path + (key,)), np.asarray(jv), ttree[key]


def assert_train_matches(jm, jp, port, rtol=1e-5, leaf_tol=1e-4):
    """Losses (and grad norms) to ``rtol`` relative each step; every
    parameter leaf within ``leaf_tol`` of its largest |value|."""
    assert len(port["metrics"]) == len(jm)
    for j, t in zip(jm, port["metrics"]):
        assert set(t) == set(j)
        for key in ("loss", "grad_norm", "router_aux"):
            if key in j:
                np.testing.assert_allclose(t[key], j[key], rtol=rtol, err_msg=key)
    for name, a, b in _pairs(jp, port["params"]):
        assert b.shape == a.shape, name
        np.testing.assert_allclose(b, a, atol=leaf_tol * np.abs(a).max(), rtol=0,
                                   err_msg=name)


def _cases(inputs):
    out = {
        "meshes": ("meshes", {}),
        "placement": ("placement", {"params": _jax_params(J.tiny(dtype="float32"))}),
        "batch_rows": ("batch_rows", {"rows": inputs["rows"]}),
        "pipeline": ("pipeline", {"params": inputs["stages"], "batch": inputs["micro"]}),
    }
    for causal in (True, False):
        q, k, v = inputs["qkv"]
        out[f"ring_{causal}"] = ("ring", dict(q=q, k=k, v=v, w=inputs["w"], causal=causal))
    for name, (mesh, opt, _, masked) in TRAIN.items():
        c = _train_config(name)
        out[name] = ("train", dict(config=dataclasses.asdict(c), params=_jax_params(c),
                                   tokens=inputs["tokens"], mesh_kind=mesh, opt_kind=opt,
                                   mask=inputs["mask"] if masked else None,
                                   routing=c.n_experts > 0))
    return out


@pytest.fixture(scope="module")
def port():
    """The port's results for every spawned case, computed by 4 gloo ranks
    in a thread while the JAX side runs: (inputs, {case: [per rank]})."""
    rng = np.random.default_rng(2)
    inputs = {
        "rows": np.arange(8)[:, None] * np.ones((1, 3), np.int64),
        "qkv": _qkv(),
        "w": rng.standard_normal(16).astype(np.float32),
        "stages": [{"w": (rng.standard_normal((8, 8)) / np.sqrt(8)).astype(np.float32)}
                   for _ in range(4)],
        "micro": rng.standard_normal((16, 8)).astype(np.float32),
        "tokens": _tokens(4, 33),
        # test_models.py's uneven mask: rows 2-3 mostly masked.
        "mask": np.concatenate([np.ones((2, 33)), np.ones((2, 33)) * (np.arange(33) < 5)]
                               ).astype(np.float32),
    }
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(_spawn.run, cases.run, DEVICES, _cases(inputs), timeout=600)
    # The JAX side's train steps run while the ranks work, compiled side
    # by side.
    with concurrent.futures.ThreadPoolExecutor(len(TRAIN)) as jax_pool:
        reference = {name: jax_pool.submit(
            jax_train, _train_config(name), _jax_params(_train_config(name)),
            inputs["tokens"], mesh, opt, mask=inputs["mask"] if masked else None)
            for name, (mesh, opt, _, masked) in TRAIN.items()}
        reference = {name: f.result() for name, f in reference.items()}
    results = {}

    def get(name):
        if not results:
            per_rank = future.result()
            results.update({key: [r[key] for r in per_rank] for key in per_rank[0]})
        return results[name]

    yield types.SimpleNamespace(inputs=inputs, params=_jax_params(J.tiny(dtype="float32")), get=get,
                                reference=reference)
    pool.shutdown()


# -- no spawn: the layout rules --------------------------------------------------

def _mesh_stand_in(sizes):
    """The two things the spec rules read of a mesh: its dim names and
    sizes (a DeviceMesh needs a process group)."""
    names = tuple(a for a in parallel.DEFAULT_AXIS_ORDER if sizes.get(a, 1) > 1) or ("data",)
    return types.SimpleNamespace(mesh_dim_names=names,
                                 size=lambda i: max(sizes.get(names[i], 1), 1))


RESOLVE = [dict(), dict(tensor=2), dict(data=3, tensor=5), dict(data=-1, fsdp=-1),
           dict(data=2, fsdp=2, tensor=2), dict(fsdp=3), dict(data=1, expert=4),
           dict(data=1, pipeline=2, sequence=2), dict(data=2, tensor=2, expert=2)]


@pytest.mark.parametrize("kw", RESOLVE, ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()) or "default")
def test_mesh_config_resolve_matches_jax(kw):
    """The -1 wildcard and its errors (tests/test_ops_parallel.py:124), at
    8 and 4 devices."""
    for n in (8, 4):
        try:
            expected = JMesh(**kw).resolve(n)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)[:20]):
                parallel.MeshConfig(**kw).resolve(n)
            continue
        assert parallel.MeshConfig(**kw).resolve(n) == expected


FSDP_CASES = [((128, 64), 8, None), ((128, 64), 8, ("tensor", None)), ((7, 5), 8, None),
              ((64, 64), 4, None), ((2, 64, 4, 16), 2, (None, None, "tensor", None)),
              ((12, 768), 1, None), ((256, 64), 4, (("data", "fsdp"), None))]


@pytest.mark.parametrize("shape,n,base", FSDP_CASES)
def test_fsdp_spec_for_matches_jax(shape, n, base):
    """The largest divisible free dim, ties to the later one."""
    got = parallel.fsdp_spec_for(shape, n, None if base is None else parallel.P(*base))
    want = jfsdp_spec_for(shape, n, None if base is None else JP(*base))
    assert tuple(got) == tuple(want)


def _spec_pairs(jtree, ttree, path=()):
    for key, jv in jtree.items():
        if isinstance(jv, dict):
            yield from _spec_pairs(jv, ttree[key], path + (key,))
        else:
            yield "/".join(path + (key,)), jv, ttree[key]


@pytest.mark.parametrize("model", ["tiny", "tiny_moe"])
@pytest.mark.parametrize("sizes", [dict(data=4), dict(fsdp=2, data=2), dict(fsdp=4),
                                   dict(tensor=2, data=2), dict(fsdp=2, tensor=2),
                                   dict(expert=2, tensor=2)],
                         ids=lambda s: "-".join(f"{k}{v}" for k, v in s.items()))
def test_param_specs_match_jax(model, sizes):
    """partition_specs and infer_param_specs (fsdp 1/2/4, tensor 2,
    expert 2), entry by entry against JAX's PartitionSpecs."""
    jc = getattr(J, model)(dtype="float32")
    tc = getattr(T, model)(dtype="float32")
    jspecs, tspecs = J.partition_specs(jc), T.partition_specs(tc)
    for name, a, b in _spec_pairs(jspecs, tspecs):
        assert (a is None and b is None) or tuple(a) == tuple(b), name
    jmesh = JMesh(**sizes).build(jax.devices()[:DEVICES])
    jinferred = jinfer(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), jc.shapes()),
                       jmesh, jspecs)
    tinferred = parallel.infer_param_specs(
        T.tree_map(lambda s: types.SimpleNamespace(shape=s), tc.shapes()),
        _mesh_stand_in(sizes), tspecs)
    for name, a, b in _spec_pairs(jinferred, tinferred):
        assert tuple(a) == tuple(b), name


# -- spawned: placement, ring attention, pipeline ----------------------------------

def test_shard_params_places_like_jax(port):
    """(data 1, fsdp 4): rank r's shard of every leaf equals the shard JAX
    puts on device r."""
    mesh = JMesh(data=1, fsdp=4).build(jax.devices()[:DEVICES])
    jc = J.tiny(dtype="float32")
    placed, _ = jshard(port.params, mesh, J.partition_specs(jc))
    per_rank = port.get("placement")
    for name, jleaf, _ in _pairs(placed, per_rank[0]["shards"]):
        by_device = {s.device: np.asarray(s.data) for s in
                     _leaf(placed, name).addressable_shards}
        for rank, got in enumerate(per_rank):
            np.testing.assert_array_equal(_leaf(got["shards"], name),
                                          by_device[jax.devices()[rank]], err_msg=name)
    assert _leaf(per_rank[0]["specs"], "layers/mlp/w_in") == "P(None, None, 'fsdp')"


def test_meshes_match_jax(port):
    """tests/test_multislice.py's checks on 4 ranks: one slice detected on
    one host; build_multislice_mesh(2, MeshConfig(fsdp=2)) has JAX's dims
    (dcn outermost), shape and batch axes; 3 slices of 4 ranks are
    refused. single_device_mesh gives each rank a ("data",) mesh of
    itself."""
    jmesh = jmultislice(2, JMesh(fsdp=2), devices=jax.devices()[:DEVICES])
    for rank, got in enumerate(port.get("meshes")):
        assert got["slices"] == jdetect() == 1
        assert got["names"] == list(jmesh.axis_names) == ["dcn", "fsdp"]
        assert got["shape"] == [jmesh.shape[a] for a in jmesh.axis_names]
        assert got["batch_axes"] == list(jbatch_axes(jmesh))
        assert got["allreduce_axes"] == list(jallreduce_axes(jmesh))
        assert "not divisible" in got["error"]
        assert got["single"] == [["data"], 1, [rank]]


def _leaf(tree, name):
    for key in name.split("/"):
        tree = tree[key]
    return tree


def test_batch_over_two_axes_splits_like_jax(port):
    """(data 2, fsdp 2): the rows rank r holds, over both axes major to
    minor, are the rows JAX puts on device r."""
    rows = port.inputs["rows"]
    mesh = JMesh(data=2, fsdp=2).build(jax.devices()[:DEVICES])
    placed = jax.device_put(rows, jbatch_sharding(mesh))
    by_device = {s.device: np.asarray(s.data) for s in placed.addressable_shards}
    for rank, got in enumerate(port.get("batch_rows")):
        want = by_device[jax.devices()[rank]]
        np.testing.assert_array_equal(got["batch_sharding"], want)
        np.testing.assert_array_equal(got["spec"], want)
        assert got["spec"][:, 0].tolist() == [2 * rank, 2 * rank + 1]


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_jax(port, causal):
    """sequence=4: the output to 2e-5, the gradients of q, k and v to 1e-5
    of each one's largest |value|, on every rank."""
    q, k, v = map(jnp.asarray, port.inputs["qkv"])
    w = jnp.asarray(port.inputs["w"])
    mesh = JMesh(data=1, sequence=4).build(jax.devices()[:DEVICES])

    def loss(q, k, v):
        return jnp.tanh(jring(q, k, v, mesh, causal=causal) @ w).sum()

    out, grads = jax.jit(lambda q, k, v: (jring(q, k, v, mesh, causal=causal),
                                          jax.grad(loss, argnums=(0, 1, 2))(q, k, v)))(q, k, v)
    out = np.asarray(out)
    for got in port.get(f"ring_{causal}"):
        np.testing.assert_allclose(got["out"], out, atol=2e-5, rtol=2e-5)
        for name, a, b in zip("qkv", grads, got["grads"]):
            a = np.asarray(a)
            np.testing.assert_allclose(b, a, atol=1e-5 * np.abs(a).max(), rtol=0,
                                       err_msg=f"d{name}")


def test_pipeline_matches_jax(port):
    """pipeline=4, 8 microbatches, against ray_tpu's pipelined_apply (the
    stage of tests/test_ops_parallel.py:150) to 1e-5 on every rank; with
    no pipeline axis the stages run in turn; a stage count other than the
    axis size is refused."""
    params = [{"w": jnp.asarray(p["w"])} for p in port.inputs["stages"]]
    batch = jnp.asarray(port.inputs["micro"])
    mesh = JMesh(data=1, pipeline=4).build(jax.devices()[:DEVICES])
    want = np.asarray(jax.jit(lambda params, batch: jpipelined(
        lambda p, x: jnp.tanh(x @ p["w"]), params, mesh, batch, num_microbatches=8))(
            params, batch))
    for got in port.get("pipeline"):
        np.testing.assert_allclose(got["out"], want, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got["sequential"], want, atol=1e-5, rtol=1e-5)
        assert got["error"] == "3 stages != pipeline axis size 4"


# -- spawned: the sharded train step ------------------------------------------------

def test_expert_parallel_routes_like_jax(port):
    """Before each step of the (data 1, expert 4) case, every rank's
    sharded forward keeps each token by the experts ray_tpu's model keeps
    it by, on the same params (compared before the values)."""
    jkept = port.reference["moe_ep4"].kept
    assert len(jkept) == 2
    for got in port.get("moe_ep4"):
        assert len(got["kept"]) == len(jkept)
        for step, (want, have) in enumerate(zip(jkept, got["kept"])):
            assert len(want) == len(have) == 2
            for layer, (a, b) in enumerate(zip(want, have)):
                assert a.shape == b.shape
                differ = int((a != b).any(-1).sum())
                assert differ == 0, f"step {step} layer {layer}: {differ} tokens rerouted"


def test_expert_weights_shard_over_expert(port):
    """The expert weights lie over the expert axis in both packages."""
    assert "expert" in port.reference["moe_ep4"].w_gate_spec
    for got in port.get("moe_ep4"):
        assert got["mesh"] == ["expert"]
        assert got["expert_placements"] == "(Shard(dim=1),)"


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_train_step_matches_jax(port, name):
    """tiny() in f32, 2 steps of make_train_step(mesh=) from JAX's params:
    (data 2, tensor 2) with FusedClipAdamW (eps 1e-3: AdamW divides a
    gradient component by its own size plus eps, and the zero-initialized
    biases' components near 0 would turn summation-order differences of
    ~1e-9 into 1e-4 of their leaf's max), (fsdp 4) with the optax-style
    chain(clip_by_global_norm, adamw), a 2-slice mesh
    build_multislice_mesh(2, MeshConfig(tensor=2)) with sgd and the batch
    over multislice_batch_axes (tests/test_multislice.py:66's recipe),
    (sequence 2, tensor 2) with sgd, the llama arch (RoPE, GQA) with
    the fused chunked loss on (fsdp 2, tensor 2), on a masked batch, and
    tiny_moe() (remat on) on (data 1, expert 4) with sgd, whose router
    aux is compared as the losses are."""
    ref = port.reference[name]
    per_rank = port.get(name)
    for got in per_rank:
        assert_train_matches(ref.metrics, ref.params, got)
    assert per_rank[0]["mesh"] == list(_jmesh(TRAIN[name][0]).axis_names)
