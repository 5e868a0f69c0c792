"""One script run under ray_tpu and under ray_tpu_torch, each in its own
process, by tests/test_torch_dag_parity.py:

    python tests/torch_dag_parity_cases.py ray_tpu|ray_tpu_torch

It prints one JSON object of outcomes: compiled DAGs (tests/
test_channels.py:156-370 and tests/test_dag_jobs.py:37-107's scenarios),
AllReduceNode, a device edge (tests/test_device_channel.py:54-92: jax
arrays in ray_tpu, CPU torch tensors in the port; values as lists),
util.collective (tests/test_collective.py:57-94) and the trainer
(JaxTrainer / TorchTrainer on a loop of plain numpy arithmetic: reports,
iterations, checkpoints kept and best, a restart after an injected
failure, the Result). It imports only the package it is given, so the
ray_tpu_torch run loads neither jax nor ray_tpu. Every get is bounded.
"""

import importlib
import json
import os
import sys
import tempfile
import time

import numpy as np

T = 30  # every get is bounded


def outcome(fn):
    try:
        return {"ok": fn()}
    except Exception as e:  # noqa: BLE001 — the class and message are the outcome
        return {"raised": type(e).__name__, "message": str(e).splitlines()[0][:80]}


def dag_cases(rt, pkg, out):
    dag = importlib.import_module(pkg + ".dag")
    InputNode, MultiOutputNode = dag.InputNode, dag.MultiOutputNode

    @rt.remote
    class Stage:
        def __init__(self, k):
            self.k = k
            self.calls = 0

        def apply(self, x):
            self.calls += 1
            return x + self.k

        def mul(self, x):
            return x * self.k

        def count(self):
            return self.calls

        def checked(self, x):
            if x < 0:
                raise ValueError("negative input")
            return x + 1

        def fail_on(self, x):
            if x == self.k:
                raise ValueError(f"boom on {x}")
            return x * 10

        def tag(self, x):
            return x + [self.k]

        def seven(self):
            return 7

        def vec(self, x):
            return np.full(3, float(x * self.k))

    def compiled_of(root):
        c = root.experimental_compile()
        return c, c._mode

    actors = []

    def new(*ks):
        made = [Stage.remote(k) for k in ks]
        actors.extend(made)
        return made

    # pipeline (test_channels.py:156, test_dag_jobs.py:53)
    a, b = new(1, 100)
    with InputNode() as inp:
        c, mode = compiled_of(b.apply.bind(a.apply.bind(inp)))
    res = [c.execute(i).get(timeout_s=T) for i in range(20)]
    out["pipeline"] = [mode, res, rt.get(a.count.remote(), timeout=T)]
    c.teardown()
    out["after_teardown"] = outcome(lambda: c.execute(0))

    # fan-out and multi-output
    a, b = new(2, 3)
    with InputNode() as inp:
        c, mode = compiled_of(MultiOutputNode([a.mul.bind(inp), b.mul.bind(inp)]))
    out["fanout"] = [mode, c.execute(5).get(timeout_s=T), rt.get(c.execute(7), timeout=T)]
    c.teardown()

    # an error propagates and the DAG survives
    (a,) = new(0)
    with InputNode() as inp:
        c, mode = compiled_of(a.checked.bind(inp))
    out["error_survives"] = [mode, outcome(lambda: c.execute(1).get(timeout_s=T)),
                             outcome(lambda: c.execute(-1).get(timeout_s=T)),
                             outcome(lambda: c.execute(5).get(timeout_s=T))]
    c.teardown()

    # local memo: two steps on one actor pass values in process
    (a,) = new(2)
    with InputNode() as inp:
        c, mode = compiled_of(a.mul.bind(a.apply.bind(inp)))
    data = [n for n in c._channels if "ready" not in n]
    out["local_memo"] = [mode, len(data), c.execute(4).get(timeout_s=T)]
    c.teardown()

    # a revisited actor: A -> B -> A
    a, b = new("a", "b")
    with InputNode() as inp:
        c, mode = compiled_of(a.tag.bind(b.tag.bind(a.tag.bind(inp))))
    out["revisited"] = [mode, c.execute([]).get(timeout_s=T),
                        c.execute(["x"]).get(timeout_s=T)]
    c.teardown()

    # one branch failing keeps the stream aligned
    a, b = new(2, None)
    with InputNode() as inp:
        c, mode = compiled_of(MultiOutputNode([a.fail_on.bind(inp), b.fail_on.bind(inp)]))
    first = c.execute(1).get(timeout_s=T)
    bad, good = c.execute(2), c.execute(3)
    out["stream_aligned"] = [mode, first, outcome(lambda: bad.get(timeout_s=T)),
                             outcome(lambda: bad.get(timeout_s=T)), good.get(timeout_s=T)]
    c.teardown()

    # an out-of-order get fails loudly
    (a,) = new(0)
    with InputNode() as inp:
        c, mode = compiled_of(a.apply.bind(inp))
    r1, r2 = c.execute(1), c.execute(2)
    out["out_of_order"] = [mode, outcome(lambda: r2.get(timeout_s=T)),
                           r1.get(timeout_s=T), r2.get(timeout_s=T)]
    c.teardown()

    # a const-only source and a function node fall back
    (a,) = new(0)
    c, mode = compiled_of(a.seven.bind())
    out["const_only"] = [mode, rt.get(c.execute(), timeout=T)]
    c.teardown()

    @rt.remote
    def plain(x):
        return x - 1

    @rt.remote
    def add(x, y):
        return x + y

    @rt.remote
    def mul(x, y):
        return x * y

    @rt.remote
    def combine(x, y):
        return (x, y)

    with InputNode() as inp:
        c, mode = compiled_of(plain.bind(inp))
    out["function_fallback"] = [mode, outcome(lambda: c.ensure_compiled() and "compiled"),
                                rt.get(c.execute(10), timeout=T)]
    c.teardown()
    with InputNode() as inp:
        s = add.bind(inp, 10)
        node = mul.bind(s, 2)
    out["function_dag"] = rt.get(node.execute(5), timeout=T)
    with InputNode() as inp:
        node = MultiOutputNode([add.bind(inp, 1), add.bind(inp, -1)])
    out["function_multi_output"] = rt.get(node.execute(10), timeout=T)

    # a diamond runs its shared node once per execute
    (t,) = new(0)
    with InputNode() as inp:
        shared = t.apply.bind(inp)
        node = combine.bind(shared, shared)
    out["diamond"] = [list(rt.get(node.execute(7), timeout=T)),
                      rt.get(t.count.remote(), timeout=T)]

    # AllReduceNode over three actors' outputs, every op
    ws = new(1, 2, 3)
    red = {}
    for op in ("sum", "mean", "max", "min"):
        with InputNode() as inp:
            node = dag.allreduce([w.vec.bind(inp) for w in ws], op=op)
        red[op] = np.asarray(rt.get(node.execute(2), timeout=T)).tolist()
    out["allreduce"] = red
    out["allreduce_bad_op"] = outcome(lambda: dag.AllReduceNode(
        [ws[0].vec.bind(1)], op="prod"))
    # refused in both (the messages say why, each for its own hardware)
    out["nccl_transport"] = outcome(
        lambda: ws[0].vec.bind(1).with_tensor_transport("nccl"))["raised"]
    for actor in actors:
        rt.kill(actor)


def device_cases(rt, pkg, out):
    dag = importlib.import_module(pkg + ".dag")
    InputNode, MultiOutputNode = dag.InputNode, dag.MultiOutputNode

    @rt.remote
    class Producer:
        def make(self, scale):
            if pkg == "ray_tpu":
                import jax.numpy as jnp

                return jnp.arange(1024, dtype=jnp.float32) * scale
            import torch

            return torch.arange(1024, dtype=torch.float32) * scale

        def make_tree(self, scale):
            if pkg == "ray_tpu":
                import jax.numpy as jnp

                return {"w": jnp.ones((8, 8), jnp.float32) * scale,
                        "tag": "meta-only-leaf", "n": 3}
            import torch

            return {"w": torch.ones((8, 8)) * scale, "tag": "meta-only-leaf", "n": 3}

    @rt.remote
    class Consumer:
        def reduce(self, arr):
            # the hand-off arrives as its framework's array (a jax.Array
            # pulled over the transfer fabric; a torch tensor), not numpy
            if pkg == "ray_tpu":
                import jax

                native = isinstance(arr, jax.Array)
            else:
                import torch

                native = isinstance(arr, torch.Tensor)
            return [native, float(arr.sum())]

        def reduce_tree(self, tree):
            return [float(tree["w"].sum()), tree["tag"], tree["n"]]

    p, c = Producer.remote(), Consumer.remote()
    with InputNode() as inp:
        node = c.reduce.bind(p.make.bind(inp).with_tensor_transport("device"))
    d = node.experimental_compile()
    d.ensure_compiled()
    got = [rt.get(d.execute(s), timeout=T) for s in (1.0, 2.0, 3.0)]
    out["device_edge"] = [d._mode, got]
    d.teardown()
    with InputNode() as inp:
        tree = p.make_tree.bind(inp).with_tensor_transport("device")
        raw = p.make.bind(inp).with_tensor_transport("device")
        node = MultiOutputNode([c.reduce_tree.bind(tree), raw])
    d = node.experimental_compile()
    d.ensure_compiled()
    red, arr = rt.get(d.execute(2.0), timeout=T)
    out["device_tree_and_driver_read"] = [list(red), np.asarray(arr).tolist()[:4],
                                          float(np.asarray(arr).sum())]
    repeated = [rt.get(d.execute(float(i)), timeout=T)[0][0] for i in range(10)]
    out["device_repeated"] = repeated
    d.teardown()
    rt.kill(p)
    rt.kill(c)


def collective_cases(rt, pkg, out):
    @rt.remote
    class Rank:
        def __init__(self, world_size, rank):
            collective = importlib.import_module(pkg + ".util.collective")
            self.g = collective.init_collective_group(world_size, rank, group_name="t")
            self.rank = rank

        def allreduce(self, value, op):
            return self.g.allreduce(np.full(4, value, dtype=np.float64), op=op).tolist()

        def broadcast(self, value=None):
            return self.g.broadcast(np.full(2, value) if value is not None else None,
                                    src=0).tolist()

        def allgather(self, value):
            return [x.tolist() for x in self.g.allgather(np.array([value]))]

        def reducescatter(self):
            return self.g.reducescatter(np.arange(4, dtype=np.float64)).tolist()

        def sendto(self, dst, value):
            self.g.send(np.array([value]), dst)

        def recvfrom(self, src):
            return self.g.recv(src).tolist()

        def barrier(self):
            self.g.barrier()
            return self.rank

        def broadcast_many(self, values, delay=0.0):
            time.sleep(delay)
            if self.rank == 0:
                return [float(self.g.broadcast(np.array([v]), timeout=20)[0]) for v in values]
            return [float(self.g.broadcast(None, timeout=20)[0]) for _ in values]

    world = [Rank.remote(3, r) for r in range(3)]
    out["coll_allreduce"] = {op: rt.get([w.allreduce.remote(float(i + 1), op)
                                         for i, w in enumerate(world)], timeout=60)
                             for op in ("sum", "mean", "max", "min")}
    out["coll_barrier"] = rt.get([w.barrier.remote() for w in world], timeout=60)
    for w in world:
        rt.kill(w)
    world = [Rank.remote(2, r) for r in range(2)]
    out["coll_broadcast"] = rt.get([world[0].broadcast.remote(7.0),
                                    world[1].broadcast.remote(None)], timeout=60)
    vals = [float(i) for i in range(6)]
    out["coll_slow_joiner"] = rt.get([world[0].broadcast_many.remote(vals),
                                      world[1].broadcast_many.remote(vals, delay=2.0)],
                                     timeout=60)
    out["coll_allgather"] = rt.get([w.allgather.remote(r) for r, w in enumerate(world)],
                                   timeout=60)
    out["coll_reducescatter"] = rt.get([w.reducescatter.remote() for w in world], timeout=60)
    send = world[0].sendto.remote(1, 42.0)
    out["coll_p2p"] = rt.get(world[1].recvfrom.remote(0), timeout=60)
    rt.get(send, timeout=60)
    for w in world:
        rt.kill(w)


def _loop(config):
    """Plain numpy arithmetic with reports, a checkpoint every other step,
    and (on rank 0 of the first attempt) a crash before step fail_at's
    report. Resumes from the checkpoint it is given."""
    train = importlib.import_module(config["pkg"] + ".train")
    ctx = train.get_context()
    ck = train.get_checkpoint()
    step0 = 0
    if ck is not None:
        with open(os.path.join(ck.path, "state.json")) as f:
            step0 = json.load(f)["step"]
    w = np.float64(step0)
    for step in range(step0, config["steps"]):
        w = w * 0.5 + 1.0
        metrics = {"loss": 1.0 / (step + 1), "w": float(w), "step": step,
                   "world": ctx.get_world_size()}
        ckpt = None
        if step % 2 == 1:
            d = train.make_temp_checkpoint_dir()
            with open(os.path.join(d, "state.json"), "w") as f:
                json.dump({"step": step + 1}, f)
            ckpt = train.Checkpoint(d)
        if step == config.get("fail_at") and ck is None and ctx.get_world_rank() == 0:
            os._exit(1)
        train.report(metrics, checkpoint=ckpt)


def train_cases(rt, pkg, out):
    train = importlib.import_module(pkg + ".train")
    if pkg == "ray_tpu":
        trainer_cls, backend = train.JaxTrainer, train.JaxConfig()
    else:
        trainer_cls, backend = train.TorchTrainer, train.TorchConfig(device="cpu")
    # The restart keeps every checkpoint: a restarted rank may read the
    # one it resumes from after rank 0 has registered newer ones.
    for key, cfg, failures, keep in (("train_plain", {"steps": 7}, 0, 2),
                                     ("train_restart", {"steps": 6, "fail_at": 3}, 1, 3)):
        with tempfile.TemporaryDirectory() as tmp:
            trainer = trainer_cls(
                _loop, train_loop_config={**cfg, "pkg": pkg},
                scaling_config=train.ScalingConfig(num_workers=2),
                run_config=train.RunConfig(
                    name="run", storage_path=tmp,
                    failure_config=train.FailureConfig(max_failures=failures),
                    checkpoint_config=train.CheckpointConfig(
                        num_to_keep=keep, checkpoint_score_attribute="loss",
                        checkpoint_score_order="min")),
                backend_config=backend)
            result = trainer.fit()
            out[key] = {
                "metrics": result.metrics,
                "history": result.metrics_history,
                "best": os.path.basename(result.checkpoint.path),
                "kept": sorted(os.listdir(os.path.join(tmp, "run"))),
                "error": result.error, "path_is_run": result.path == os.path.join(tmp, "run")}
    with tempfile.TemporaryDirectory() as tmp:
        trainer = trainer_cls(
            _loop, train_loop_config={"steps": 4, "fail_at": 1, "pkg": pkg},
            scaling_config=train.ScalingConfig(num_workers=1),
            run_config=train.RunConfig(name="run", storage_path=tmp), backend_config=backend)
        out["train_failure_raises"] = outcome(trainer.fit)["raised"]


def main(pkg: str) -> dict:
    rt = importlib.import_module(pkg)
    rt.init(num_cpus=4, object_store_memory=64 * 1024 * 1024,
            _system_config={"head_shards": 1})
    out = {}
    try:
        dag_cases(rt, pkg, out)
        device_cases(rt, pkg, out)
        collective_cases(rt, pkg, out)
        train_cases(rt, pkg, out)
    finally:
        rt.shutdown()
    out["foreign_modules"] = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "ray_tpu") and pkg != "ray_tpu")
    return out


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1]), sort_keys=True, default=repr))
