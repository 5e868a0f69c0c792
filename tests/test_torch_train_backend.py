"""The port's Train backend (ray_tpu_torch.train) against ray_tpu.train on
the CPU: the config dataclasses' derived values, CheckpointManager's
retention, ``latest``, ``best`` and manifest after the same
registrations, tensor-tree checkpoints bit for bit (f32, bf16, DTensor
leaves restored into other placements), the gradient and parameter sync
of a data-parallel loop, the backend's worker setup and the session.

The sync helpers run on 4 gloo ranks (spawned once for the file, in a
thread while the JAX side runs; the ranks run tests/torch_train_cases.py,
which imports no JAX) against ray_tpu.train.jax_utils's own functions,
run here for each of the 4 ranks in a session of world size 4 whose
collective group is the test's: it holds every rank's flat buffer and
reduces them as ray_tpu's host group does, in numpy. Limits: f32 means
within 1e-6 of each leaf's largest |value|, bf16 within one bf16 ulp
(the ranks sum in another order, then both round to bf16); parameters
bit for bit.
"""

import concurrent.futures
import dataclasses
import json
import os
import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.train import backend as jbackend
from ray_tpu.train import checkpoint as jckpt
from ray_tpu.train import config as jconfig
from ray_tpu.train import jax_utils
from ray_tpu.train import session as jsession
from ray_tpu.util import collective
from ray_tpu_torch import train
from ray_tpu_torch.ops.optim import FusedClipAdamW, ScaleByAdamState
from ray_tpu_torch.parallel import _spawn
from ray_tpu_torch.train import session as tsession
import torch_train_cases as cases

WORLD = 4
# Leaves of the synced trees: (shape, dtype).
LEAVES = {"w": ((6, 5), "float32"), "b": ((5,), "float32"),
          "head": {"w": ((4, 8), "bfloat16"), "scale": ((), "float32")}}


# A tree whose leaves sit at byte offsets 0, 6 and 14: the f32 and int64
# leaves are not at a multiple of their size in the packed buffer.
MIXED = {"a": ((3,), "bfloat16"), "b": ((2,), "float32"), "c": ((), "int64")}


def _mixed_per_rank(seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(WORLD):
        a = torch.from_numpy(rng.standard_normal(3).astype(np.float32)).bfloat16().float()
        out.append({"a": a.numpy(), "b": rng.standard_normal(2).astype(np.float32),
                    "c": np.asarray(rng.integers(-2**62, 2**62), np.int64)})
    return out, {k: v[1] for k, v in MIXED.items()}


def _per_rank(seed):
    """Each rank's tree of numpy float32 arrays (bf16 leaves hold bf16
    values exactly) and the dtype of each leaf."""
    rng = np.random.default_rng(seed)

    def make(spec):
        if isinstance(spec, dict):
            return {k: make(v) for k, v in spec.items()}
        shape, dtype = spec
        a = np.asarray(rng.standard_normal(shape) * rng.uniform(0.1, 10), np.float32)
        if dtype == "bfloat16":
            a = torch.from_numpy(a).bfloat16().float().numpy()
        return a

    def dtypes(spec):
        return {k: dtypes(v) if isinstance(v, dict) else v[1] for k, v in spec.items()}

    return [make(LEAVES) for _ in range(WORLD)], dtypes(LEAVES)


def _leaf_items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_items(v, prefix + k + ".")
        else:
            yield prefix + k, v


def _jax_tree(arrays, dtypes):
    return {k: (_jax_tree(v, dtypes[k]) if isinstance(v, dict)
                else jnp.asarray(v).astype(dtypes[k])) for k, v in arrays.items()}


class _Group:
    """ray_tpu's host collective group across WORLD ranks, seen from one
    rank: the other ranks' contributions are known in advance."""

    def __init__(self, flats, rank0_obj=None):
        self.flats, self.rank0_obj = flats, rank0_obj

    def allreduce(self, tensor, op="sum"):
        out = np.stack(self.flats)
        return {"sum": out.sum(axis=0), "mean": out.mean(axis=0)}[op]

    def broadcast_object(self, obj, src=0):
        return self.rank0_obj


def _flat(tree):
    """The buffer ray_tpu's allreduce_gradients sends for ``tree``."""
    return np.concatenate([np.asarray(l).astype(np.float32).ravel()
                           for l in jax.tree.leaves(tree)])


def _in_jax_session(rank, fn, group, monkeypatch):
    name = "test-group"
    monkeypatch.setitem(collective._groups, name, group)
    jsession.set_session(jsession.TrainSession(rank, WORLD, rank, None, "t",
                                               group_name=name))
    try:
        return fn(name)
    finally:
        jsession.set_session(None)


# -- the ranks ------------------------------------------------------------------

CKPT_LEAVES = {"a": "float32", "b": "bfloat16", "c": "float32"}
SAVE_AS = {"a": ["S0", "S1"], "b": ["S1", "R"], "c": ["R", "S0"]}
LOAD_AS = [((2, 2), {"a": ["R", "S0"], "b": ["S0", "S0"], "c": ["S1", "R"]}),
           ((4,), {"a": ["S1"], "b": ["R"], "c": ["S0"]})]


def _ckpt_leaves():
    rng = np.random.default_rng(5)
    out = {"a": rng.standard_normal((7, 5)).astype(np.float32),   # uneven shards
           "b": torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32))
                     .bfloat16().float().numpy(),
           "c": rng.standard_normal((3, 8)).astype(np.float32)}
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    grads, gtypes = _per_rank(0)
    params, ptypes = _per_rank(1)
    mixed, mtypes = _mixed_per_rank(2)
    leaves = _ckpt_leaves()
    path = str(tmp_path_factory.mktemp("dtensor_ckpt") / "state")
    run_cases = {
        "sync": ("sync", dict(per_rank=params, dtypes=ptypes)),
        "sync_mixed": ("sync", dict(per_rank=mixed, dtypes=mtypes)),
        "named": ("named_group", dict(per_rank=grads, dtypes=gtypes)),
        "mean": ("allreduce", dict(per_rank=grads, dtypes=gtypes, op="mean")),
        "sum": ("allreduce", dict(per_rank=grads, dtypes=gtypes, op="sum")),
        "ckpt": ("checkpoint", dict(path=path, leaves=leaves,
                                    save_as={k: (CKPT_LEAVES[k], p) for k, p in SAVE_AS.items()},
                                    load_as=[(s, {k: (CKPT_LEAVES[k], p) for k, p in lay.items()})
                                             for s, lay in LOAD_AS])),
    }
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        future = pool.submit(_spawn.run, cases.run, WORLD, run_cases, timeout=180)
        yield types.SimpleNamespace(result=future.result, grads=(grads, gtypes),
                                    params=(params, ptypes), mixed=(mixed, mtypes),
                                    leaves=leaves)


def _as_float(a):
    """A rank's leaf (bf16 as its int16 view) as float64."""
    if a.dtype == np.int16:
        return torch.from_numpy(a).view(torch.bfloat16).double().numpy()
    return a.astype(np.float64)


@pytest.mark.parametrize("op", ["mean", "sum"])
def test_allreduce_gradients_matches_jax(ranks, op, monkeypatch):
    grads, dtypes = ranks.grads
    jtrees = [_jax_tree(g, dtypes) for g in grads]
    group = _Group([_flat(t) for t in jtrees])
    per_rank = [r[op] for r in ranks.result()]
    for rank in range(WORLD):
        want = _in_jax_session(rank, lambda name: jax_utils.allreduce_gradients(
            jtrees[rank], group_name=name, op=op), group, monkeypatch)
        got = dict(_leaf_items(per_rank[rank]))
        for key, w in _leaf_items(want):
            g = got[key]
            w = np.asarray(w)
            if w.dtype == jnp.bfloat16:
                assert g.dtype == np.int16  # stayed bf16
                w = w.astype(np.float64)
                ulp = np.ldexp(1.0, np.frexp(np.abs(w))[1] - 8)  # bf16: 8 bits
                assert (np.abs(_as_float(g) - w) <= ulp).all(), key
            else:
                assert g.dtype == w.dtype
                np.testing.assert_allclose(g, w, rtol=0,
                                           atol=1e-6 * np.abs(w).max())


def test_sync_model_params_matches_jax(ranks, monkeypatch):
    params, dtypes = ranks.params
    jtrees = [_jax_tree(p, dtypes) for p in params]
    rank0 = [np.asarray(l) for l in jax.tree.leaves(jtrees[0])]
    for rank, got in enumerate(r["sync"] for r in ranks.result()):
        want = _in_jax_session(rank, lambda name: jax_utils.sync_model_params(
            jtrees[rank], group_name=name), _Group([], rank0), monkeypatch)
        got = dict(_leaf_items(got))
        for key, w in _leaf_items(want):
            w = np.asarray(w)
            if w.dtype == jnp.bfloat16:
                assert np.array_equal(got[key], w.view(np.int16))
            else:
                assert got[key].dtype == w.dtype and np.array_equal(got[key], w)


def test_sync_model_params_keeps_mixed_dtypes(ranks, monkeypatch):
    """An odd-length bf16 leaf, then f32, then an int64 scalar: every rank
    gets rank 0's leaves bit for bit in their own dtypes, the values
    ray_tpu's sync_model_params gives (its int64 becomes int32 without
    jax's x64 mode, so values are compared there)."""
    mixed, dtypes = ranks.mixed
    rank0 = mixed[0]
    jrank0 = [np.asarray(rank0[k]).astype(dtypes[k] if dtypes[k] != "bfloat16"
                                          else jnp.bfloat16) for k in sorted(rank0)]
    for rank, got in enumerate(r["sync_mixed"] for r in ranks.result()):
        assert got["a"].dtype == np.int16 and got["b"].dtype == np.float32
        assert got["c"].dtype == np.int64 and got["c"].shape == ()
        assert np.array_equal(got["a"], torch.from_numpy(rank0["a"]).bfloat16()
                              .view(torch.int16).numpy())
        assert np.array_equal(got["b"].view(np.int32), rank0["b"].view(np.int32))
        assert got["c"] == rank0["c"]
        want = _in_jax_session(rank, lambda name: jax_utils.sync_model_params(
            _jax_tree(mixed[rank], dtypes), group_name=name), _Group([], jrank0), monkeypatch)
        assert np.array_equal(_as_float(got["a"]), np.asarray(want["a"], np.float64))
        assert np.array_equal(got["b"], np.asarray(want["b"]))
        jc = np.asarray(want["c"])
        assert got["c"].astype(jc.dtype) == jc  # the port's int64, cut to JAX's int32


def test_sync_helpers_take_the_reference_group_name(ranks):
    """sync_model_params, allreduce_gradients and barrier take ray_tpu's
    second parameter, a group name: the one TorchBackend.on_worker_setup
    registered resolves to the run's group; an unknown name raises
    ValueError naming it, a non-str TypeError."""
    grads, dtypes = ranks.grads
    results = ranks.result()
    want_sum = {k: sum(np.asarray(g[k], np.float64) for g in grads) for k in ("w", "b")}
    for rank, got in enumerate(r["named"] for r in results):
        assert all(np.array_equal(got["sync"][k], results[0]["named"]["sync"][k])
                   for k in ("w", "b"))
        assert np.array_equal(got["sync"]["w"], grads[0]["w"])
        for k in ("w", "b"):
            np.testing.assert_allclose(got["sum"][k], want_sum[k], rtol=0,
                                       atol=1e-6 * np.abs(want_sum[k]).max())
        for fn in ("sync_model_params", "allreduce_gradients", "barrier"):
            assert "'no-such-group'" in got[f"{fn}-ValueError"], (rank, fn)
            assert "must be a str" in got[f"{fn}-TypeError"], (rank, fn)


def test_world_of_one_sends_nothing():
    """At world size 1 both packages return their input as it is, with no
    group at all."""
    tree = {"w": torch.ones(3), "b": torch.zeros(2, dtype=torch.bfloat16)}
    train.session.set_session(tsession.TrainSession(0, 1, 0))
    try:
        assert train.torch_utils.allreduce_gradients(tree) is tree
        assert train.torch_utils.sync_model_params(tree) is tree
        assert train.torch_utils.barrier() is None
    finally:
        train.session.set_session(None)
    jsession.set_session(jsession.TrainSession(0, 1, 0, None, "t"))
    try:
        assert jax_utils.allreduce_gradients(tree) is tree
    finally:
        jsession.set_session(None)


def test_dtensor_checkpoint_restores_into_other_placements(ranks):
    """Saved by shard on (data 2, tensor 2) (uneven shards included),
    restored on every rank into other placements on that mesh and on a
    1-D mesh of 4, and whole: every shard bit for bit what
    distribute_tensor gives from the same leaves, bf16 staying bf16."""
    leaves = ranks.leaves
    results = ranks.result()
    for rank, res in enumerate(r["ckpt"] for r in results):
        for i, (shape, layout) in enumerate(LOAD_AS):
            got = res[f"load{i}"]
            assert int(got["step"]) == 7 and got["lr"] == 0.5
            for k in layout:
                assert np.array_equal(got["params"][k], got["want"][k]), (rank, i, k)
                assert (got["params"][k].dtype == np.int16) == (CKPT_LEAVES[k] == "bfloat16")
        for k, full in leaves.items():
            assert np.array_equal(_as_float(res["whole"]["params"][k]), full)
    # Only the owners of a shard wrote it: every replicated shard once.
    files = results[0]["ckpt"]["files"]
    assert "tree.json" in files and "arrays.npz" in files
    assert sum(f.startswith("shards-") for f in files) == WORLD


# -- checkpoints in one process -----------------------------------------------

def _state(dtype):
    g = torch.Generator().manual_seed(3)
    params = {"w": torch.randn(5, 3, generator=g).to(dtype),
              "layers": {"b": torch.randn(4, generator=g).to(dtype)}}
    opt = FusedClipAdamW()
    return {"params": params, "opt_state": opt.init(params),
            "adam": ScaleByAdamState(torch.tensor(2, dtype=torch.int32),
                                     {"w": torch.randn(5, 3, generator=g)}, [torch.ones(2)]),
            "step": torch.tensor(11, dtype=torch.int32), "lr": 3e-4, "name": "run"}


def _same_bits(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_bits(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(map(_same_bits, a, b))
    if isinstance(a, torch.Tensor):
        return (a.dtype == b.dtype and a.shape == b.shape and a.device == b.device
                and torch.equal(a.view(torch.uint8) if a.dim() else a, b.view(torch.uint8)
                                if b.dim() else b))
    return a == b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tree_checkpoint_round_trip_is_bitwise(dtype, tmp_path):
    """A train state (params, FusedClipAdamW's moments, an optax-style
    NamedTuple state, scalars) through save_pytree/load_pytree: with a
    target, the same types and bits; without, the same values whole."""
    state = _state(dtype)
    ckpt = train.Checkpoint.from_directory(str(tmp_path))
    ckpt.save_pytree(state)
    back = ckpt.load_pytree(_state(dtype))
    assert _same_bits(back, state)
    assert type(back["adam"]) is ScaleByAdamState
    plain = train.load_pytree(str(tmp_path / "state"), device="cpu")
    assert isinstance(plain["adam"], tuple) and _same_bits(plain["params"], state["params"])
    assert plain["lr"] == 3e-4 and plain["name"] == "run"


def test_load_refuses_a_different_tree(tmp_path):
    train.save_pytree({"w": torch.zeros(2, 3)}, str(tmp_path / "s"))
    with pytest.raises(ValueError):
        train.load_pytree(str(tmp_path / "s"), {"w": torch.zeros(3, 2)})
    with pytest.raises(ValueError):
        train.load_pytree(str(tmp_path / "s"), {"v": torch.zeros(2, 3)})


# -- CheckpointManager and the configs ------------------------------------------

MANAGERS = [
    dict(num_to_keep=2, score_attribute="acc", score_order="max", scores=[0.1, 0.9, 0.5, 0.7]),
    dict(num_to_keep=2, score_attribute="loss", score_order="min", scores=[0.4, 0.2, 0.9, 0.2]),
    dict(num_to_keep=3, score_attribute="acc", score_order="max",
         scores=[None, 0.3, None, 0.8, 0.1]),
    dict(num_to_keep=None, score_attribute=None, score_order="max", scores=[1, 2, 3]),
    dict(num_to_keep=1, score_attribute="acc", score_order="max", scores=[None, None]),
]


def _drive(mod, root, kw):
    kw = dict(kw)
    scores = kw.pop("scores")
    m = mod.CheckpointManager(os.path.join(root, "store"), **kw)
    for i, s in enumerate(scores):
        d = tempfile.mkdtemp(dir=root)
        with open(os.path.join(d, "x"), "w") as f:
            f.write(str(i))
        m.register(d, {} if s is None else {kw["score_attribute"] or "v": s, "i": i})
    rel = lambda c: None if c is None else os.path.basename(c.path)  # noqa: E731
    with open(os.path.join(root, "store", "manifest.json")) as f:
        manifest = [dict(r, path=os.path.basename(r["path"])) for r in json.load(f)]
    return {"kept": sorted(os.listdir(os.path.join(root, "store"))), "latest": rel(m.latest),
            "best": rel(m.best), "manifest": manifest}


@pytest.mark.parametrize("kw", MANAGERS)
def test_checkpoint_manager_matches_reference(kw, tmp_path):
    """The same registrations (tests/test_train.py:196 and variants:
    min order, unscored checkpoints, no limit): the same directories
    kept, latest, best and manifest."""
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    assert _drive(train, str(tmp_path / "t"), kw) == _drive(jckpt, str(tmp_path / "j"), kw)


SCALING = [dict(), dict(num_workers=4, min_workers=2), dict(num_workers=2, min_workers=2),
           dict(use_tpu=True, tpus_per_worker=4, cpus_per_worker=2),
           dict(use_tpu=True, resources_per_worker={"TPU": 8, "mem": 1.0})]


# The port's chip resource is "GPU" and its fields use_gpu/gpus_per_worker
# (use_tpu/tpus_per_worker are aliases): compared with TPU and GPU mapped
# to each other.
_TO_REF = {"GPU": "TPU", "use_gpu": "use_tpu", "gpus_per_worker": "tpus_per_worker"}


def _as_ref(d):
    return {_TO_REF.get(k, k): v for k, v in d.items()}


@pytest.mark.parametrize("kw", SCALING)
def test_scaling_config_matches_reference(kw):
    port_kw = dict(kw)
    if kw.get("resources_per_worker"):
        port_kw["resources_per_worker"] = {{"TPU": "GPU"}.get(k, k): v
                                           for k, v in kw["resources_per_worker"].items()}
    j, t = jconfig.ScalingConfig(**kw), train.ScalingConfig(**port_kw)
    ref = dataclasses.asdict(j)
    if ref["resources_per_worker"]:
        ref["resources_per_worker"] = port_kw["resources_per_worker"]
    assert _as_ref(dataclasses.asdict(t)) == ref
    assert t.elastic == j.elastic
    assert _as_ref(t.worker_resources()) == j.worker_resources()
    # The port's own names give the same config as the aliases.
    named = {{"use_tpu": "use_gpu", "tpus_per_worker": "gpus_per_worker"}.get(k, k): v
             for k, v in port_kw.items()}
    assert train.ScalingConfig(**named) == t
    assert "TPU" not in t.worker_resources()


@pytest.mark.parametrize("kw", [dict(), dict(name="r"), dict(storage_path="/data/x", name="r")])
def test_run_config_and_result_match_reference(kw):
    assert (train.RunConfig(**kw).resolved_storage_path()
            == jconfig.RunConfig(**kw).resolved_storage_path())
    for cls in ("FailureConfig", "CheckpointConfig"):
        assert (dataclasses.asdict(getattr(train, cls)())
                == dataclasses.asdict(getattr(jconfig, cls)()))
    for ck in (None, "ckpt"):
        assert (train.Result({}, ck, "p").best_checkpoints
                == jconfig.Result({}, ck, "p").best_checkpoints)


# -- the backend and the session -------------------------------------------------

def test_worker_setup_sets_the_reference_env(monkeypatch):
    """on_worker_setup's RANK, WORLD_SIZE and LOCAL_RANK are the
    reference's; with distributed="off" it starts no group."""
    seen = []
    for setup in (lambda: jbackend.JaxBackend().on_worker_setup(
                      3, 4, "g", jbackend.JaxConfig(distributed="off", collective_group=False)),
                  lambda: train.TorchBackend().on_worker_setup(
                      3, 4, "g", train.TorchConfig(distributed="off", collective_group=False,
                                                   device="cpu"))):
        for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
            monkeypatch.setenv(key, "unset")
        setup()
        seen.append({k: os.environ[k] for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK")})
    assert seen[0] == seen[1] == {"RANK": "3", "WORLD_SIZE": "4", "LOCAL_RANK": "3"}
    assert not torch.distributed.is_initialized()


def test_worker_setup_starts_the_group(monkeypatch, tmp_path):
    """distributed="on" at world size 1 on the CPU: a gloo default group
    at the coordinator address, with the configured timeout."""
    import datetime

    import torch.distributed as dist

    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.setenv(key, "unset")
    calls = []
    real = dist.init_process_group
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: (calls.append((a, kw)), real(*a, **kw))[1])
    store = f"file://{tmp_path}/store"
    cfg = train.TorchConfig(distributed="on", device="cpu", timeout_s=42.0,
                            coordinator_address=store)
    train.TorchBackend().on_worker_setup(0, 1, "g", cfg)
    try:
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert dist.get_world_size() == 1
        assert calls == [(("gloo",), dict(init_method=store, rank=0, world_size=1,
                                           timeout=datetime.timedelta(seconds=42.0)))]
    finally:
        dist.destroy_process_group()
    assert train.TorchConfig(coordinator_address="h:29500").init_method() == "tcp://h:29500"
    assert train.TorchConfig().init_method() == "env://"


def test_session_errors_match_reference():
    for mod in (jsession, tsession):
        mod.set_session(None)
    errors = []
    for mod in (jsession, tsession):
        with pytest.raises(RuntimeError) as e:
            mod.get_session()
        errors.append(str(e.value))
        assert not mod.in_session()
    assert errors[0] == errors[1]
    tsession.set_session(tsession.TrainSession(2, 4, 1, latest_checkpoint="c",
                                               dataset_shards={"train": [1]}))
    try:
        ctx = train.get_context()
        assert (ctx.get_world_rank(), ctx.get_world_size(), ctx.get_local_rank()) == (2, 4, 1)
        assert train.get_checkpoint() == "c" and train.get_dataset_shard() == [1]
        with pytest.raises(KeyError):
            train.get_dataset_shard("eval")
        # report is an actor call to the run's state actor, which only
        # TorchTrainer.fit gives a session (tests/test_torch_trainer.py).
        with pytest.raises(RuntimeError, match="state actor"):
            train.report({"loss": 1.0})
    finally:
        tsession.set_session(None)
    assert os.path.isdir(train.make_temp_checkpoint_dir())
