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


def case_imports(inputs):
    """The modules a rank loaded: no JAX, no ``veles_tpu``."""
    import veles_tpu_torch.parallel  # noqa: F401
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
