"""Worlds of gloo ranks for the port's multi-rank tests, and the cases
the ranks run.  Nothing here imports JAX: a rank process runs this file
as a script and imports only torch, numpy and ``veles_tpu_torch``.

The test side calls :func:`run_world` (or boots the ranks itself, as
``spmd_launch`` does): each rank pins torch to one thread, joins the
group through a ``FileStore`` file in the test's ``tmp_path`` (six
xdist workers run at once, so no fixed port), loads the inputs the test
saved, runs every case named and pickles ``{case: result}`` (numpy
arrays, lists, numbers) into ``rank<r>.pkl``.  A rank that fails prints
its traceback and exits non-zero; :func:`run_world` joins every rank
with a timeout, kills the world when it hangs and raises with the
ranks' errors.
"""

import os
import pickle
import subprocess
import sys
import time

import numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: seconds a world may take before it is killed
WORLD_TIMEOUT = 240


def run_world(world, cases, inputs, tmp_path, timeout=WORLD_TIMEOUT):
    """Run ``cases`` (names of :data:`CASES`) in ``world`` ranks; the
    ranks' results, a list of ``{case: result}`` in rank order."""
    tmp = str(tmp_path)
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "file://" + os.path.join(
            tmp, "store"), str(world), str(rank), tmp, ",".join(cases)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in range(world)]
    deadline = time.monotonic() + timeout
    outputs = [None] * world
    try:
        for rank, proc in enumerate(procs):
            left = max(1.0, deadline - time.monotonic())
            outputs[rank] = proc.communicate(timeout=left)[0].decode()
    except subprocess.TimeoutExpired:
        for proc in procs:
            proc.kill()
        for proc in procs:
            proc.communicate()
        raise AssertionError("the %d-rank world hung past %d s (cases %s)"
                             % (world, timeout, cases))
    failed = [(r, p.returncode, outputs[r]) for r, p in enumerate(procs)
              if p.returncode]
    if failed:
        raise AssertionError("ranks failed: %s" % "\n".join(
            "rank %d rc=%d:\n%s" % f for f in failed))
    return load_results(tmp, world)


def load_results(directory, world):
    out = []
    for rank in range(world):
        with open(os.path.join(directory, "rank%d.pkl" % rank), "rb") as f:
            out.append(pickle.load(f))
    return out


# -- the rank side -----------------------------------------------------------

def _np(t):
    return t.detach().to("cpu", copy=True).numpy()


def _tensor(a, grad=False):
    import torch
    t = torch.tensor(numpy.asarray(a))
    return t.requires_grad_(True) if grad else t


def _attention_case(inputs, fn, **kwargs):
    """Forward and q/k/v gradients of ``fn`` on the data 2 x seq 4 mesh
    (global results gathered on every rank)."""
    import torch
    from veles_tpu_torch.parallel import mesh as M
    mesh = M.make_mesh({"data": 2, "seq": 4})
    spec = ("data", "seq", None, None)
    out = {}
    for causal in (False, True):
        q, k, v = (_tensor(M.shard(inputs[n], spec, mesh), True)
                   for n in ("q", "k", "v"))
        o = fn(q, k, v, mesh, causal=causal, **kwargs)
        cot = _tensor(M.shard(inputs["cot"], spec, mesh))
        grads = torch.autograd.grad((o * cot).sum(), (q, k, v))
        out[causal] = [_np(M.unshard(t.detach(), spec, mesh))
                       for t in (o,) + tuple(grads)]
    return out


def case_ring_flash(inputs):
    from veles_tpu_torch.parallel.ring import ring_attention
    return _attention_case(inputs, ring_attention)


def case_ring_oracle(inputs):
    from veles_tpu_torch.parallel.ring import ring_attention
    return _attention_case(inputs, ring_attention, use_flash=False)


def case_ulysses(inputs):
    from veles_tpu_torch.parallel.ring import ulysses_attention
    return _attention_case(inputs, ulysses_attention)


def case_pipeline(inputs):
    """``pipeline_apply`` on pipe 4 x data 2: the output, the stacked
    params' gradients and x's, gathered."""
    import torch
    from veles_tpu_torch.parallel import mesh as M
    from veles_tpu_torch.parallel.pp import pipeline_apply
    mesh = M.make_mesh({"pipe": 4, "data": 2})
    params = {n: _tensor(M.shard(inputs["stages"][n],
                                 ("pipe",) + (None,) * (
                                     inputs["stages"][n].ndim - 1), mesh),
                         True) for n in ("w", "b")}
    x = _tensor(M.shard(inputs["x"], ("data", None), mesh), True)

    def stage(p, h):
        return torch.tanh(h @ p["w"] + p["b"])
    out = pipeline_apply(stage, params, x, mesh, n_micro=2,
                         batch_axis="data")
    cot = _tensor(M.shard(inputs["cot_x"], ("data", None), mesh))
    gw, gb, gx = torch.autograd.grad((out * cot).sum(),
                                     (params["w"], params["b"], x))
    # a stage's gradient sums over the data ranks that fed it
    from veles_tpu_torch.parallel.comm import all_reduce
    data = mesh.group("data")
    gw, gb = (all_reduce(g.clone(), data) for g in (gw, gb))
    return {"out": _np(M.unshard(out.detach(), ("data", None), mesh)),
            "w": _np(M.unshard(gw, ("pipe", None, None), mesh)),
            "b": _np(M.unshard(gb, ("pipe", None), mesh)),
            "x": _np(M.unshard(gx, ("data", None), mesh))}


def case_moe(inputs):
    """``moe_mlp`` on data 2 x model 4 at two capacity factors: the
    output and every gradient, gathered."""
    import torch
    from veles_tpu_torch.parallel import mesh as M
    from veles_tpu_torch.parallel.comm import all_reduce
    from veles_tpu_torch.parallel.moe import moe_mlp
    mesh = M.make_mesh({"data": 2, "model": 4})
    xs = ("data", "model", None)
    out = {}
    for factor in (1.0, 8.0):
        params = {n: _tensor(M.shard(a, ("model",) + (None,) * (a.ndim - 1)
                                     if n != "router" else (), mesh), True)
                  for n, a in inputs["moe"].items()}
        x = _tensor(M.shard(inputs["moe_x"], xs, mesh), True)
        y = moe_mlp(x, params, mesh, capacity_factor=factor)
        cot = _tensor(M.shard(inputs["moe_cot"], xs, mesh))
        names = sorted(params)
        grads = torch.autograd.grad((y * cot).sum(),
                                    [params[n] for n in names] + [x])
        got = {"y": _np(M.unshard(y.detach(), xs, mesh)),
               "x": _np(M.unshard(grads[-1], xs, mesh))}
        for name, g in zip(names, grads[:-1]):
            if name == "router":
                got[name] = _np(all_reduce(g.clone(), mesh.group(
                    "data", "model")))
            else:
                spec = ("model",) + (None,) * (g.dim() - 1)
                got[name] = _np(M.unshard(all_reduce(
                    g.clone(), mesh.group("data")), spec, mesh))
        out[factor] = got
    return out


def _dp_specs(inputs):
    return [dict(s) for s in inputs["dp_specs"]]


def case_data_parallel(inputs):
    """Two ``data_parallel`` steps on data 8 (two rows a rank of a
    16-row batch): the state after them and the metrics."""
    import torch
    from veles_tpu_torch.parallel import mesh as M
    from veles_tpu_torch.parallel.dp import data_parallel
    from veles_tpu_torch.znicz.fused_graph import (lower_specs, to_numpy,
                                                   to_tensors)
    mesh = M.make_mesh({"data": 8})
    params, step_fn, _e, _a = lower_specs(
        _dp_specs(inputs), (inputs["dp_x"].shape[1],),
        grad_reduce_axis="data", mesh=mesh)
    params = to_tensors(params, "cpu")
    step = data_parallel(step_fn, mesh)
    x, y = torch.tensor(inputs["dp_x"]), torch.tensor(inputs["dp_y"])
    metrics = []
    for _ in range(2):
        params, m = step(params, x, y)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"state": to_numpy(params), "metrics": metrics}


def case_data_parallel_epoch_local(inputs):
    """One ``data_parallel_epoch_local`` epoch on data 8 (each rank its
    8 samples, minibatches of 4, the epoch key 5 folded with its
    index)."""
    import torch
    from veles_tpu_torch.parallel import mesh as M
    from veles_tpu_torch.parallel.dp import data_parallel_epoch_local
    from veles_tpu_torch.znicz.fused_graph import (lower_specs, to_numpy,
                                                   to_tensors)
    mesh = M.make_mesh({"data": 8})
    params, step_fn, _e, _a = lower_specs(
        _dp_specs(inputs), (inputs["dp_x"].shape[1],),
        grad_reduce_axis="data", mesh=mesh)
    params = to_tensors(params, "cpu")
    x = M.shard(torch.tensor(inputs["epoch_x"]), ("data", None), mesh)
    y = M.shard(torch.tensor(inputs["epoch_y"]), ("data",), mesh)
    epoch = data_parallel_epoch_local(step_fn, mesh, x.shape[0], 4)
    params, stacked = epoch(params, x.contiguous(), y.contiguous(), 5)
    return {"state": to_numpy(params),
            "metrics": {k: _np(v) for k, v in stacked.items()}}


def _gather_tree(tree, specs, mesh):
    from veles_tpu_torch.parallel.mesh import unshard
    return {k: (_gather_tree(v, specs[k], mesh) if isinstance(v, dict)
                else _np(unshard(v.detach(), specs[k], mesh)))
            for k, v in tree.items()}


def _transformer(inputs, topology, **kwargs):
    """One TINY f32 step over ``topology``: the loss and the gathered
    params; rank 0 also runs the no-mesh step."""
    import torch
    from veles_tpu_torch.parallel.mesh import mesh_from_topology
    from veles_tpu_torch.samples import transformer as T
    from veles_tpu_torch.gen.model import params_to_numpy
    cfg = dict(T.TINY)
    mesh = mesh_from_topology(topology)
    p, v, step = T.build_train(cfg, mesh=mesh, device="cpu",
                               compute_dtype=torch.float32, remat=False,
                               **kwargs)
    loss = float(step(p, v, inputs["tokens"])[2]["loss"])
    specs = T.param_specs(T.init_params(cfg))
    out = {"loss": loss, "params": _gather_tree(p, specs, mesh)}
    if mesh.rank == 0:
        p1, v1, step1 = T.build_train(cfg, device="cpu",
                                      compute_dtype=torch.float32,
                                      remat=False, **kwargs)
        out["single_loss"] = float(step1(p1, v1, inputs["tokens"])[2][
            "loss"])
        out["single_params"] = params_to_numpy(p1)
    return out


def case_transformer(inputs):
    return _transformer(inputs, "data=2,seq=2,model=2")


def case_transformer_chunked(inputs):
    return _transformer(inputs, "data=4,seq=1,model=2", ce_chunk=4)


def case_moe_sample(inputs):
    """The MoE sample on expert 2 x data 2 (ranks 0-3 of the world; the
    others only make the groups): the losses of 3 steps and the
    gathered params."""
    from veles_tpu_torch.parallel.mesh import make_mesh, unshard
    from veles_tpu_torch.samples import moe
    mesh = make_mesh({"expert": 2, "data": 2})
    if mesh.coords is None:
        return None
    cfg = moe.TINY
    p, v, step = moe.build_train(cfg, mesh=mesh, device="cpu")
    losses = [float(step(p, v, inputs["moe_tokens"])[2]["loss"])
              for _ in range(3)]
    specs = moe.param_specs(moe.init_params(cfg))
    return {"losses": losses,
            "params": {k: _np(unshard(t.detach(), specs[k], mesh))
                       for k, t in p.items()}}


def _fused_run(epoch_mode=False):
    """The MNIST sample fused with ``mesh_axes={"data": 2}`` for two
    epochs: the Decision's closes and the trained weights."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.samples import mnist
    prng.seed_all(3)
    config = {"mesh_axes": {"data": 2}}
    if epoch_mode:
        config["epoch_mode"] = True
    wf = mnist.create_workflow(device="cpu", max_epochs=2, native=True,
                               fused=True, fused_config=config)
    dec, closes = wf.decision, []
    close = dec._close_class

    def recording(cls, check_epoch_end):
        closes.append((int(dec.epoch_number), int(cls),
                       float(dec.epoch_n_err[cls])))
        return close(cls, check_epoch_end)
    dec._close_class = recording
    wf.run()
    weights = []
    for fwd in wf.forwards:
        weights.append((numpy.array(fwd.weights.mem, numpy.float32),
                        numpy.array(fwd.bias.mem, numpy.float32)))
    return {"closes": closes, "weights": weights}


def case_fused_mnist_dp(inputs):
    return _fused_run()


def case_fused_mnist_dp_epoch(inputs):
    return _fused_run(epoch_mode=True)


def _fused_sharded_run(config):
    """The MNIST sample fused over ``config`` (its ``mesh_axes`` with
    ``fsdp`` / ``tp``) for two epochs: the closes, the trained weights,
    each leaf's spec and the collectives."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.parallel import comm
    from veles_tpu_torch.samples import mnist
    prng.seed_all(3)
    wf = mnist.create_workflow(device="cpu", max_epochs=2, native=True,
                               fused=True, fused_config=dict(config))
    dec, closes = wf.decision, []
    close = dec._close_class

    def recording(cls, check_epoch_end):
        closes.append((int(dec.epoch_number), int(cls),
                       float(dec.epoch_n_err[cls])))
        return close(cls, check_epoch_end)
    dec._close_class = recording
    comm.reset_counts()
    wf.run()
    trainer = wf.fused_trainer
    return {"closes": closes,
            "weights": [(numpy.array(f.weights.mem, numpy.float32),
                         numpy.array(f.bias.mem, numpy.float32))
                        for f in wf.forwards],
            "specs": [{k: list(v) for k, v in layer.items()}
                      for layer in trainer._specs_],
            "local": [{k: list(v.shape) for k, v in layer.items()
                       if v is not None and v.dim()}
                      for layer in trainer._params_],
            "state": trainer.capture_state(),
            "collectives": {k: int(comm.counts[k]) for k in comm.KINDS}}


def case_fused_fsdp(inputs):
    return _fused_sharded_run({"mesh_axes": {"data": -1}, "fsdp": True})


def case_fused_fsdp_epoch(inputs):
    return _fused_sharded_run({"mesh_axes": {"data": -1}, "fsdp": True,
                               "epoch_mode": True})


def case_fused_tp(inputs):
    return _fused_sharded_run({"mesh_axes": {"data": 2, "model": 2},
                               "tp": True})


def case_fused_tp_fsdp(inputs):
    return _fused_sharded_run({"mesh_axes": {"data": 2, "model": 2},
                               "tp": True, "fsdp": True})


def case_fused_step_rules(inputs):
    """Three steps of the lowered specs under sharded params on every
    rank (``test_fused_parallel.py:137`` and ``:175``): fsdp_rules at 64
    elements over data 4, and the last dim of the 2-d weights over model
    2 on data 2 x model 2; the state gathered whole and the metrics."""
    import torch
    from veles_tpu_torch.parallel import mesh as M
    from veles_tpu_torch.parallel.dp import (data_parallel, fsdp_rules,
                                             shard_params)
    from veles_tpu_torch.znicz.fused_graph import (_leaf_spec, lower_specs,
                                                   to_tensors)
    out = {}
    x, y = inputs["rules_x"], inputs["rules_y"]
    for name, axes in (("fsdp", {"data": 4}),
                       ("tp", {"data": 2, "model": 2})):
        mesh = M.make_mesh(axes)
        if name == "fsdp":
            rules = fsdp_rules(mesh, min_elements=64)
        else:
            def rules(leaf):
                shape = numpy.shape(leaf)
                if len(shape) == 2 and shape[1] % 2 == 0:
                    return (None, "model")
                return None
        params, step_fn, _e, _a = lower_specs(
            [dict(s) for s in inputs["rules_specs"]], (x.shape[1],),
            grad_reduce_axis="data", mesh=mesh, param_rules=rules)
        specs = [{k: _leaf_spec(rules, v) for k, v in state.items()}
                 for state in params]
        params = to_tensors(shard_params(params, mesh, param_rules=rules),
                            "cpu")
        step = data_parallel(step_fn, mesh)
        metrics = []
        for _ in range(3):
            params, m = step(params, torch.tensor(x), torch.tensor(y))
            metrics.append({k: float(v) for k, v in m.items()})
        whole = [{k: None if v is None else _np(
            M.unshard(v, specs[i][k], mesh) if any(specs[i][k]) else v)
            for k, v in state.items()} for i, state in enumerate(params)]
        out[name] = {"state": whole, "metrics": metrics,
                     "specs": [{k: list(v) for k, v in s.items()}
                               for s in specs]}
    return out


def case_fused_topology_change(inputs):
    """``test_fused_parallel.py:201``: the lowered params placed over
    data 4 (``fsdp_rules`` at 64 elements), gathered whole, then placed
    over data 2 (the first two ranks): the whole tree and this rank's
    slices under each mesh."""
    from veles_tpu_torch.parallel import mesh as M
    from veles_tpu_torch.parallel.dp import fsdp_rules, shard_params
    from veles_tpu_torch.znicz.fused_graph import (_leaf_spec, lower_specs,
                                                   to_tensors)
    params, _s, _e, _a = lower_specs(
        [dict(s) for s in inputs["rules_specs"]],
        (inputs["rules_x"].shape[1],))
    out = {}
    for name, axes in (("data4", {"data": 4}), ("data2", {"data": 2})):
        mesh = M.make_mesh(axes)
        rules = fsdp_rules(mesh, min_elements=64)
        specs = [{k: _leaf_spec(rules, v) for k, v in state.items()}
                 for state in params]
        placed = to_tensors(shard_params(params, mesh, param_rules=rules),
                            "cpu")
        out[name] = {"local": [{k: None if v is None else _np(v)
                                for k, v in state.items()}
                               for state in placed]}
        if mesh.coords is not None:
            out[name]["whole"] = [
                {k: None if v is None else _np(
                    M.unshard(v, specs[i][k], mesh) if any(specs[i][k])
                    else v) for k, v in state.items()}
                for i, state in enumerate(placed)]
    return out


def case_fused_dp_step(inputs):
    """One fused DP step of the lowered specs on every rank of the world
    (``data`` = the world), each rank its rows of the global batch."""
    import torch
    from veles_tpu_torch.parallel import mesh as M
    from veles_tpu_torch.parallel.dp import data_parallel
    from veles_tpu_torch.znicz.fused_graph import (lower_specs, to_numpy,
                                                   to_tensors)
    mesh = M.make_mesh({"data": -1})
    params, step_fn, _e, _a = lower_specs(
        _dp_specs(inputs), (inputs["dp_x"].shape[1],),
        grad_reduce_axis="data", mesh=mesh)
    params = to_tensors(params, "cpu")
    params, m = data_parallel(step_fn, mesh)(
        params, torch.tensor(inputs["dp_x"]), torch.tensor(inputs["dp_y"]))
    return {"state": to_numpy(params),
            "metrics": {k: float(v) for k, v in m.items()}}


# -- the pod (veles_tpu_torch.pod) --------------------------------------------

def _pod_weights(wf):
    """The forwards' weights and biases and the GD units' momenta (the
    Vectors a unit has)."""
    vecs = [vec for fwd in wf.forwards for vec in (fwd.weights, fwd.bias)]
    vecs += [vec for gd in wf.gds
             for vec in (gd.gradient_weights, gd.gradient_bias)]
    out = []
    for vec in vecs:
        if vec:
            vec.map_read()
            out.append(numpy.array(vec.mem))
    return out


def _pod_run(epochs, topology=None, install=True, scan="off", health="off",
             param_rules=None, hook=None, layers=None, batch=64, make=None):
    """The pod's seeded task (or ``make(max_epochs, batch)``'s workflow)
    trained ``epochs`` epochs under a PodRuntime (``install=False``: the
    single-device stitched run): eval metrics, weights and momenta, the
    pod's report, the collectives by kind and the segments'
    dispatches."""
    from veles_tpu_torch import prof, trace
    from veles_tpu_torch.config import root
    from veles_tpu_torch.parallel import comm
    from veles_tpu_torch.parallel.mesh import mesh_from_topology
    from veles_tpu_torch.pod import PodRuntime, eval_metrics, train_epochs
    from veles_tpu_torch.pod.__main__ import make_workflow
    from veles_tpu_torch.watch import health as watch_health
    eng = root.common.engine
    eng.epoch_scan, eng.health, eng.trace = scan, health, "on"
    trace.configure()
    trace.recorder.clear()
    if make is None:
        wf = make_workflow(max_epochs=epochs, device="cpu", layers=layers,
                           batch=batch)
    else:
        wf = make(epochs, batch)
    pod = None
    if install:
        rules = param_rules(mesh_from_topology(topology)) \
            if param_rules else None
        pod = PodRuntime(wf, mesh=mesh_from_topology(topology),
                         param_rules=rules).install()
    comm.reset_counts()
    recompiles = prof.ledger.recompiles
    done = []
    for epoch in train_epochs(wf, epochs):
        done.append(epoch)
        if hook is not None:
            hook(wf, pod, epoch)
    out = {"metrics": eval_metrics(wf), "epochs_run": done,
           "collectives": {k: int(comm.counts[k]) for k in comm.KINDS},
           "dispatches": trace.recorder.count("segment", "dispatch"),
           "recompiles": prof.ledger.recompiles - recompiles,
           "health": watch_health.monitor.snapshot() if health != "off"
           else None,
           "scan": wf.epoch_scan_report()}
    if pod is not None:
        out["pod"] = pod.describe()
        out["lanes"] = sorted({ev[5] for ev in trace.recorder.events()
                               if ev[1:3] == ("pod", "shard_dispatch")})
        out["ledger"] = [
            {"name": e.name, "shards": e.shards,
             "bytes": e.collective_bytes, "dispatches": e.dispatches,
             "steps": e.steps}
            for e in prof.ledger.entries("segment")]
        out["reshard_instants"] = trace.recorder.count("pod", "reshard")
        out["stall_instants"] = trace.recorder.count("jobs",
                                                     "heartbeat_stall")
    if pod is None or not pod.left:
        out["weights"] = _pod_weights(wf)
    eng.epoch_scan, eng.health, eng.trace = "off", "off", "off"
    trace.configure()
    return out


def case_pod(inputs):
    """The pod over every rank of the world (data axis), per step."""
    return _pod_run(inputs["pod_epochs"])


#: a minibatch of 40 over 4 ranks, 10 rows each: the last train
#: minibatch of the pod's task has 24 rows (rank 2 serves 4, rank 3
#: padding only), the last validation minibatch 8 (ranks 1-3 padding)
TAIL_BATCH = 40


def case_pod_tail(inputs):
    """The pod's task at :data:`TAIL_BATCH`: short tails in both
    classes."""
    return _pod_run(inputs["pod_epochs"], batch=TAIL_BATCH)


#: the regression stack of the MSE tail case
MSE_LAYERS = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 8},
     "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
    {"type": "all2all", "->": {"output_sample_shape": 4},
     "<-": {"learning_rate": 0.05}}]


def _mse_tail_workflow(epochs, batch):
    """A seeded regression task with short tails at a minibatch of 40:
    252 train rows (the last minibatch 12: rank 1 serves 2, ranks 2 and
    3 padding) and 68 validation rows (the last 28: rank 3 padding), 16
    features, targets ``tanh(x[:, :4] / 2)``."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.backends import make_device
    from veles_tpu_torch.dummy import DummyLauncher
    from veles_tpu_torch.loader.fullbatch import FullBatchLoaderMSE
    from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow

    class TailMSELoader(FullBatchLoaderMSE):
        def load_data(self):
            rng = numpy.random.default_rng(3)
            data = rng.standard_normal((320, 16)).astype(numpy.float32)
            self.original_data.mem = data
            self.original_targets.mem = numpy.tanh(
                data[:, :4] * 0.5).astype(numpy.float32)
            self.class_lengths[:] = [0, 68, 252]

    prng.seed_all(5)
    wf = StandardWorkflow(
        None, loader_factory=lambda w: TailMSELoader(
            w, minibatch_size=batch),
        layers=[dict(spec) for spec in MSE_LAYERS], loss_function="mse",
        decision_config={"max_epochs": epochs})
    wf.launcher = DummyLauncher()
    wf.initialize(device=make_device("cpu"))
    return wf


def case_pod_mse_tail(inputs):
    """The MSE evaluator over the pod with short tails, beside the
    single-device stitched run."""
    epochs = inputs["pod_epochs"]
    return {"reference": _pod_run(epochs, install=False, batch=TAIL_BATCH,
                                  make=_mse_tail_workflow),
            "pod": _pod_run(epochs, batch=TAIL_BATCH,
                            make=_mse_tail_workflow)}


def case_pod_reference(inputs):
    """The single-device stitched run and the pod over a one-rank
    group, in one process."""
    return {"reference": _pod_run(inputs["pod_epochs"], install=False),
            "pod": _pod_run(inputs["pod_epochs"])}


def case_pod_windows(inputs):
    """The pod's epoch-scan windows with health on, and the per-step pod
    route with health on."""
    return {"windows": _pod_run(inputs["pod_epochs"], scan="auto",
                                health="on"),
            "steps": _pod_run(inputs["pod_epochs"], health="on")}


#: a stack whose backward is the VJP family: rprop_all2all trains through
#: GDRProp, a GDViaVJP, which sums its gradients over the data group
VJP_LAYERS = [
    {"type": "rprop_all2all", "->": {"output_sample_shape": 12}},
    {"type": "activation_tanh"},
    {"type": "softmax", "->": {"output_sample_shape": 5},
     "<-": {"learning_rate": 0.05}}]


def case_pod_vjp(inputs):
    """The VJP family under the pod (each rank its rows, the summed
    gradients all-reduced) beside the single-device run."""
    return {"reference": _pod_run(inputs["pod_epochs"], install=False,
                                  layers=VJP_LAYERS),
            "pod": _pod_run(inputs["pod_epochs"], layers=VJP_LAYERS)}


def case_pod_fsdp(inputs):
    """The pod with every parameter leaf of at least 16 elements
    sharded over the data axis (fsdp_rules)."""
    from veles_tpu_torch.parallel.dp import fsdp_rules
    return _pod_run(inputs["pod_epochs"], param_rules=lambda mesh:
                    fsdp_rules(mesh, min_elements=16))


def case_pod_serve(inputs):
    """``InferenceEngine`` over the world's data mesh (``test_pod.py:
    422``): the seeded task trained one epoch, served plain, over the
    mesh replicated, over the mesh with the 2-d weights whose last dim
    divides by the world column-sharded, and over a one-rank mesh."""
    from veles_tpu_torch.parallel import comm
    from veles_tpu_torch.parallel.mesh import Mesh, make_mesh
    from veles_tpu_torch.pod import train_epochs
    from veles_tpu_torch.pod.__main__ import make_workflow
    from veles_tpu_torch.serve.engine import InferenceEngine
    wf = make_workflow(max_epochs=1, device="cpu")
    for _ in train_epochs(wf, 1):
        pass
    batch = inputs["serve_batch"]
    mesh = make_mesh({"data": -1})

    def rule(leaf):
        shape = numpy.shape(leaf)
        if len(shape) == 2 and shape[-1] % mesh.size == 0:
            return (None, "data")
        return None
    out = {}
    for name, kwargs in (("plain", {}), ("sharded", {"mesh": mesh}),
                         ("tp", {"mesh": mesh, "param_specs": rule}),
                         ("fallback", {"mesh": Mesh({"data": 1},
                                                    world_size=1)})):
        comm.reset_counts()
        engine = InferenceEngine.from_workflow(wf, max_batch_size=8,
                                               device="cpu", **kwargs)
        engine.warmup()
        out[name] = {"y": engine.infer(batch),
                     "mesh": None if engine.mesh is None
                     else dict(engine.mesh.shape),
                     "sharded": engine.describe()["sharded"],
                     "gathers": int(comm.counts["all_gather"])}
    return out


def case_multihost_poll(inputs):
    """``MultiHostPod.poll`` over the world: host "b" falls silent on the
    coordinator's clock; its verdict reaches every rank, which reshards
    together (the last rank leaves)."""
    from veles_tpu_torch.pod import MultiHostPod
    from veles_tpu_torch.pod.__main__ import make_workflow
    wf = make_workflow(max_epochs=1, device="cpu")
    pod = MultiHostPod(wf, heartbeat_timeout=5.0).install()
    before = pod.runtime.shards
    pod.beat("a", now=100.0)
    pod.beat("b", now=100.0)
    pod.beat("a", now=110.0)
    lost = pod.poll(now=110.0)
    return {"before": before, "lost": lost, "shards": pod.runtime.shards,
            "left": pod.runtime.left,
            "generation": pod.runtime.generation,
            "processes": pod.process_count}


def case_multihost_self_beats(inputs):
    """``MultiHostPod.beat()`` with no host on every rank: each process
    beats only itself, the beats reach the coordinator at each poll, and
    the last process falls silent after the first poll; the second poll
    declares it lost on every rank, which reshards together (the last
    rank leaves)."""
    import torch.distributed as dist
    from veles_tpu_torch.pod import MultiHostPod
    from veles_tpu_torch.pod.__main__ import make_workflow
    wf = make_workflow(max_epochs=1, device="cpu")
    pod = MultiHostPod(wf, heartbeat_timeout=5.0).install()
    last = pod.process_count - 1
    pod.beat(now=100.0)
    first = pod.poll(now=100.0)
    if dist.get_rank() != last:
        pod.beat(now=110.0)
    lost = pod.poll(now=110.0)
    return {"first": first, "lost": lost, "shards": pod.runtime.shards,
            "left": pod.runtime.left,
            "generation": pod.runtime.generation,
            "stalls": pod.detector.stalls,
            "hosts": pod.detector.hosts()}


def case_vector_sharding(inputs):
    """``Vector.set_sharding`` over the data axis of the world: the
    device holds the rank's rows, ``shape`` stays global, a host read
    gathers, and a replicated or cleared placement keeps the values."""
    from veles_tpu_torch.backends import make_device
    from veles_tpu_torch.memory import Vector
    from veles_tpu_torch.parallel.mesh import Sharding, make_mesh
    mesh = make_mesh({"data": -1})
    vec = Vector(numpy.arange(64, dtype=numpy.float32))
    vec.initialize(make_device("cpu"))
    vec.devmem
    vec.set_sharding(Sharding(mesh, ("data",)))
    out = {"local": [int(v) for v in vec.devmem.tolist()],
           "shape": list(vec.shape)}
    vec.devmem.add_(0)
    vec.devmem = vec.devmem                     # the device is fresher
    vec.map_read()
    out["gathered"] = [int(v) for v in vec.mem]
    vec.set_sharding(Sharding(mesh, ()))
    out["replicated"] = [int(v) for v in vec.devmem.tolist()]
    vec.set_sharding(None)
    out["cleared"] = [int(v) for v in vec.devmem.tolist()]
    out["sharding_after"] = vec.sharding
    return out


def case_pod_reshard(inputs, scan="off", param_rules=None):
    """A heartbeat-silent host after the second epoch: the detector
    reshards the pod 4 -> 2 (the windows invalidated), ranks 2 and 3
    leave and the survivors finish the run."""
    from veles_tpu_torch.pod import DeviceLossDetector
    clock = {"now": 100.0}
    state = {}

    def hook(wf, pod, epoch):
        if epoch != 2:
            return
        det = DeviceLossDetector(pod, timeout=5.0, devices_per_host=1,
                                 clock=lambda: clock["now"])
        for host in range(4):
            det.beat("host-%d" % host)
        clock["now"] += 10.0
        for host in range(3):
            det.beat("host-%d" % host)        # host-3 falls silent
        state["lost"] = det.poll()
        state["stalls"] = det.stalls
        state["after"] = det.poll()
    out = _pod_run(inputs["pod_epochs"], scan=scan, hook=hook,
                   param_rules=param_rules)
    out.update(state)
    return out


def case_pod_reshard_fsdp(inputs):
    """:func:`case_pod_reshard` with every leaf of 16 elements or more
    sharded over the data axis: the reshard gathers them over the old
    mesh and cuts the new mesh's slices."""
    from veles_tpu_torch.parallel.dp import fsdp_rules
    return case_pod_reshard(inputs, param_rules=lambda mesh: fsdp_rules(
        mesh, min_elements=16))


def case_pod_reshard_windows(inputs):
    """:func:`case_pod_reshard` under epoch-scan windows."""
    return case_pod_reshard(inputs, scan="auto")


# -- checkpoints across rank counts -----------------------------------------

def _ckpt_mesh_state(mesh, specs):
    """The JAX test's state (``w`` = arange(64) 8x8, ``vw`` zeros,
    ``step_scale`` 0.5) with ``w`` / ``vw`` held as this rank's slices
    under ``specs``."""
    import torch
    from veles_tpu_torch.checkpoint import ShardedLeaf
    from veles_tpu_torch.parallel.mesh import Sharding, shard
    full = {"w": numpy.arange(64, dtype=numpy.float32).reshape(8, 8),
            "vw": numpy.zeros((8, 8), numpy.float32)}
    state = {name: ShardedLeaf(torch.tensor(numpy.ascontiguousarray(shard(
        full[name], specs[name], mesh))), Sharding(mesh, specs[name]))
        for name in full}
    state["step_scale"] = numpy.float32(0.5)
    return state


def _fsdp_pod_workflow(epochs):
    from veles_tpu_torch.parallel.dp import fsdp_rules
    from veles_tpu_torch.parallel.mesh import mesh_from_topology
    from veles_tpu_torch.pod import PodRuntime
    from veles_tpu_torch.pod.__main__ import make_workflow
    wf = make_workflow(max_epochs=epochs, device="cpu")
    mesh = mesh_from_topology(None)
    pod = PodRuntime(wf, mesh=mesh, param_rules=fsdp_rules(
        mesh, min_elements=16)).install()
    return wf, pod


def case_ckpt_save(inputs):
    """Save the sharded JAX-test state (step 1) and the train state of
    the seeded task after one epoch of an fsdp pod (step 2)."""
    from veles_tpu_torch.checkpoint import TrainCheckpointer
    from veles_tpu_torch.parallel.mesh import make_mesh
    from veles_tpu_torch.pod import train_epochs
    mesh = make_mesh({"data": -1})
    ckpt = TrainCheckpointer(inputs["ckpt_dir"])
    ckpt.save(1, _ckpt_mesh_state(mesh, {"w": ("data", None),
                                         "vw": ("data", None)}),
              loader_state={"epoch": 2, "offset": 40})
    wf, _pod = _fsdp_pod_workflow(1)
    for _ in train_epochs(wf, 1):
        pass
    train, meta = wf.capture_train_state()
    ckpt.save(2, train, meta)
    return {"train": train}


def case_ckpt_restore(inputs):
    """Restore step 1 onto ``w`` sharded by rows and ``vw`` by columns
    of this world's data axis, and step 2 into a fresh fsdp pod's
    workflow; the train state read back whole."""
    from veles_tpu_torch.checkpoint import ArraySpec, TrainCheckpointer
    from veles_tpu_torch.parallel.mesh import Sharding, make_mesh, unshard
    mesh = make_mesh({"data": -1})
    ckpt = TrainCheckpointer(inputs["ckpt_dir"])
    specs = {"w": ("data", None), "vw": (None, "data")}
    abstract = {name: ArraySpec((8, 8), numpy.float32, "cpu",
                                Sharding(mesh, spec))
                for name, spec in specs.items()}
    abstract["step_scale"] = ArraySpec((), numpy.float32, None)
    step, restored, loader = ckpt.restore(abstract, step=1)
    out = {"step": step, "loader": loader,
           "local": {n: _np(restored[n]) for n in specs},
           "whole": {n: _np(unshard(restored[n], specs[n], mesh))
                     for n in specs},
           "step_scale": float(restored["step_scale"])}
    wf, pod = _fsdp_pod_workflow(1)
    abstract_train, _meta = wf.capture_train_state()
    step, train, meta = ckpt.restore(abstract_train, step=2)
    wf.restore_train_state(train, meta)
    out["restored_units"] = sorted(train)
    out["train"], _m = wf.capture_train_state()
    out["shards"] = pod.shards
    out["sharded_leaves"] = sum(1 for vec in pod._sharded_vecs
                                if vec.category == "params")
    return out


# -- the tensor-parallel generative engine ------------------------------------

def _gen_run(engine, workload, sequential=False):
    from veles_tpu_torch.gen import GenerativeScheduler
    scheduler = GenerativeScheduler(engine)
    out = []
    if sequential:
        for toks, max_new in workload:
            future = scheduler.submit(toks, max_new)
            scheduler.run_until_idle()
            out.append(future.result(0))
        return out
    futures = [scheduler.submit(toks, max_new) for toks, max_new in workload]
    scheduler.run_until_idle()
    return [f.result(0) for f in futures]


def case_gen_tp(inputs):
    """The TINY generative engine over ``{"model": world}``, contiguous
    and paged, continuous and sequential; the attention kernels' head
    counts and the all-reduces; then a 2-layer f32 prefill's logits."""
    import torch
    from veles_tpu_torch.gen import GenerativeEngine, TransformerGenModel
    from veles_tpu_torch.ops import attention
    from veles_tpu_torch.parallel import comm
    from veles_tpu_torch.parallel.mesh import make_mesh
    cfg, workload = inputs["gen_cfg"], inputs["gen_workload"]
    mesh = make_mesh({"model": -1})
    out = {}
    for kv in ("contiguous", "paged"):
        options = {"kv": kv, "block_size": 8} if kv == "paged" else {}
        runs = {}
        for mode in ("continuous", "sequential"):
            comm.reset_counts()
            engine = GenerativeEngine(
                TransformerGenModel(cfg, device="cpu"), max_slots=2,
                max_seq=48, prefill_buckets=(8, 16), seed=0, device="cpu",
                mesh=mesh, **options)
            engine.warmup()
            runs[mode] = _gen_run(engine, workload,
                                  sequential=mode == "sequential")
            runs[mode + "_all_reduce"] = int(comm.counts["all_reduce"])
            runs["describe"] = {k: v for k, v in engine.describe().items()
                                if k in ("sharded", "mesh", "local_heads",
                                         "kv_cache_bytes")}
            runs["cache_heads"] = int(engine._cache["k"].shape[3])
            engine.close()
        out[kv] = runs
    # the logits of one prefill, f32, 2 layers
    small = dict(cfg, layers=2)
    model = TransformerGenModel(small, device="cpu").shard(
        mesh.index("model"), mesh.shape["model"], mesh.group("model"))
    tokens = torch.tensor(inputs["gen_workload"][0][0], dtype=torch.long)
    out["logits"] = _np(model.calibration_logits(
        model.shard_params(model.init_params(seed=1)), tokens))
    out["local_heads"] = model.heads
    return out


def case_imports(inputs):
    """The modules a rank loaded: no JAX, no ``veles_tpu``."""
    import veles_tpu_torch.parallel  # noqa: F401
    import veles_tpu_torch.pod  # noqa: F401
    import veles_tpu_torch.pod.__main__  # noqa: F401
    import veles_tpu_torch.samples.moe  # noqa: F401
    import veles_tpu_torch.scripts.spmd_launch  # noqa: F401
    return sorted(m for m in sys.modules if m == "jax"
                  or m.startswith("jax.") or m == "veles_tpu"
                  or m.startswith("veles_tpu."))


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


def main(argv):
    """``torch_ranks.py STORE WORLD RANK OUT CASES`` (a world of
    :func:`run_world`), or ``torch_ranks.py --fleet OUT CASES`` under
    ``spmd_launch`` (the rendezvous from the ``VELES_*`` variables)."""
    import torch
    torch.set_num_threads(1)
    from veles_tpu_torch.parallel import multihost
    if argv[0] == "--fleet":
        out_dir, cases = argv[1], argv[2]
        multihost.initialize(device="cpu", timeout=WORLD_TIMEOUT)
        inputs_dir = out_dir
    else:
        store, world, rank, out_dir, cases = argv
        multihost.initialize(store, int(world), int(rank), device="cpu",
                             timeout=WORLD_TIMEOUT)
        inputs_dir = out_dir
    with open(os.path.join(inputs_dir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    results = {name: CASES[name](inputs) for name in cases.split(",")}
    rank = multihost.process_index()
    with open(os.path.join(out_dir, "rank%d.pkl" % rank), "wb") as f:
        pickle.dump(results, f)
    # every rank done before any leaves the group
    import torch.distributed as dist
    dist.barrier()
    multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
