#!/usr/bin/env python3
"""Probe why the conv workflow's parameters drift between the card and
the CPU, three ways.

Run from the root of a checkout on a machine with one CUDA card:

    python3 scripts/conv_drift_probe.py [--steps 120] [--epochs 2]
        [--out FILE] [--parts workflow,steps,alexnet,speed]

- ``workflow``: ``chip_smoke.py``'s ``mnist_conv_parity`` runs (the
  eager workflow, 2 epochs, minibatch 100, on the stand-in) on the card
  with cuDNN as the port leaves it and with
  ``torch.backends.cudnn.deterministic = True`` (``benchmark`` False),
  twice each, against the CPU run; and the same for a tie-free copy of
  the LeNet stack (tanh convs, average pooling: no max-pool or relu
  choice for a sum to break apart).  Each leaf's max abs difference over
  its largest value, the weights' and the momenta's worst, and the gap
  between the two card runs.
- ``steps``: each stack lowered to one fused step (``lower_specs``'s
  apply function, the mean cross-entropy, the momentum update) and run
  ``--steps`` times over the stand-in's first minibatches, on the card
  in f32 (both cuDNN modes) and on the CPU in f32 and in float64 (the
  fully-connected layers as plain f64 products): each run's leaves
  against the f64 run after the first step and after the last.
- ``alexnet``: the same step of AlexNet at batch 8 (one step, the
  synthetic batch of ``chip_smoke.py``'s parity step), card f32 in both
  modes and CPU f32, against CPU f64.
- ``speed``: AlexNet f32 at batch 128, images/s of the captured step
  with cuDNN in each mode, in turns.

If the card's f32 run and the CPU's f32 run sit as far from the f64 run
as from each other, the drift is f32 rounding that the stack's choices
carry, not a fault of the card's path.  Prints one JSON object a line
and writes them all to ``--out``.
"""

import argparse
import contextlib
import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


def tie_free(layers):
    """``layers`` with every strict-relu conv made a tanh conv and every
    max pooling an average pooling."""
    out = copy.deepcopy(layers)
    for spec in out:
        if spec["type"] == "conv_strict_relu":
            spec["type"] = "conv_tanh"
        elif spec["type"] == "max_pooling":
            spec["type"] = "avg_pooling"
    return out


@contextlib.contextmanager
def cudnn_mode(deterministic):
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = deterministic
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved


def emit(rows, obj):
    rows.append(obj)
    print(json.dumps(obj), flush=True)


def worst(errs):
    weights, momenta = cs._split_leaves(errs, "gradient_")
    return {"weights": max(weights.values()),
            "momenta": max(momenta.values())}


def workflow_part(rows, device, epochs):
    from veles_tpu_torch.samples import mnist_conv
    for stack, layers in (("lenet", None),
                          ("tie_free", tie_free(mnist_conv.LAYERS))):
        tic = time.perf_counter()
        _wf, c_closes, _conf, c_params = cs._conv_run(
            torch.device("cpu"), epochs, "off", layers)
        cpu_s = time.perf_counter() - tic
        for mode in ("default", "deterministic"):
            runs = []
            with cudnn_mode(mode == "deterministic"):
                for _ in range(2):
                    _wf, closes, _conf, params = cs._conv_run(
                        device, epochs, "off", layers)
                    runs.append((closes, params))
            errs = [cs._param_rel_errors(p, c_params) for _c, p in runs]
            gap = max(float(numpy.abs(runs[0][1][k] - runs[1][1][k]).max())
                      for k in runs[0][1])
            emit(rows, {"part": "workflow", "stack": stack, "mode": mode,
                        "epochs": epochs, "cpu_s": cpu_s,
                        "closes_equal": [c == c_closes for c, _p in runs],
                        "card_vs_cpu": [worst(e) for e in errs],
                        "rel_err_by_leaf": errs[0],
                        "card_runs_bit_equal": gap == 0.0,
                        "card_repeat_max_abs_gap": gap})


def _plain_all2all(params, x, activation=None, is_softmax=False,
                   transposed=False):
    """All2All.pure_fn as plain products in the input's type (float64
    here: the port's own widens the softmax layer to f32)."""
    from veles_tpu_torch.ops import gemm
    from veles_tpu_torch.znicz import all2all
    h = x.reshape(x.shape[0], -1)
    w = params["w"].t() if transposed else params["w"]
    out = h @ w
    if params.get("b") is not None:
        out = out + params["b"]
    if is_softmax:
        return all2all._softmax(out)
    return gemm._activate(out, activation)


@contextlib.contextmanager
def plain_f64_all2all():
    from veles_tpu_torch.znicz import all2all
    saved = all2all.All2All.__dict__["pure_fn"]
    all2all.All2All.pure_fn = staticmethod(_plain_all2all)
    try:
        yield
    finally:
        all2all.All2All.pure_fn = saved


def own_step(layers, shape, device, dtype):
    """``(params, step)``: the stack lowered by ``lower_specs`` (seeded),
    its floating state cast to ``dtype`` on ``device``; ``step(x,
    labels)`` runs the apply function in train mode, the mean
    cross-entropy of the probabilities, its gradient and the momentum
    update in place, and advances the dropout seeds."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.znicz import fused_graph
    prng.seed_all(cs.SEED)
    f64 = dtype == torch.float64
    with plain_f64_all2all() if f64 else contextlib.nullcontext():
        host, _step, _eval, apply_fn = fused_graph.lower_specs(layers, shape)
    params = fused_graph.to_tensors(host, device)
    for state in params:
        for key, value in state.items():
            if value is not None and value.is_floating_point():
                state[key] = value.to(dtype)
    hypers = [fused_graph._hyper(spec.get("<-", {}), "momentum")
              for spec in layers]

    def step(x, labels):
        with plain_f64_all2all() if f64 else contextlib.nullcontext():
            keys = [[k for k in ("w", "b") if s.get(k) is not None]
                    for s in params]
            with torch.enable_grad():
                leaves = [dict(s, **{k: s[k].detach().requires_grad_(True)
                                     for k in ks})
                          for s, ks in zip(params, keys)]
                out = apply_fn(leaves, x, train=True)
                picked = torch.gather(torch.log(torch.clamp(out, min=1e-30)),
                                      1, labels.long()[:, None])[:, 0]
                loss = -picked.sum() / x.shape[0]
                flat = [leaf[k] for leaf, ks in zip(leaves, keys)
                        for k in ks]
                grads = iter(torch.autograd.grad(loss, flat))
            with torch.no_grad():
                for state, ks, hyper in zip(params, keys, hypers):
                    fused_graph._solver_update(
                        state, {k: next(grads) for k in ks}, hyper, None)
                    if "seed" in state:
                        seed = state["seed"]
                        seed.copy_((seed + 1).bitwise_and(
                            fused_graph.SEED_MASK))
        return float(loss.detach())

    return params, step


def leaves_of(params):
    out = {}
    for i, state in enumerate(params):
        for key in ("w", "b", "vw", "vb"):
            if state.get(key) is not None:
                out["%d.%s" % (i, key)] = state[key].detach().cpu().double() \
                    .numpy().copy()
    return out


def rel_errs(got, want):
    return {k: float(numpy.abs(got[k] - ref).max()
                     / max(float(numpy.abs(ref).max()), 1e-300))
            for k, ref in want.items()}


def split_worst(errs):
    weights = {k: v for k, v in errs.items() if ".v" not in k}
    momenta = {k: v for k, v in errs.items() if ".v" in k}
    return {"weights": max(weights.values()),
            "momenta": max(momenta.values()) if momenta else None}


VARIANTS = (("card_f32", "cuda", torch.float32, False),
            ("card_f32_deterministic", "cuda", torch.float32, True),
            ("cpu_f32", "cpu", torch.float32, False),
            ("cpu_f64", "cpu", torch.float64, False))


def run_variants(layers, shape, batches, steps):
    """Each variant's leaves after the first and after the last of
    ``steps`` steps over ``batches`` (cycled)."""
    snaps = {}
    for name, dev, dtype, det in VARIANTS:
        with cudnn_mode(det):
            params, step = own_step(layers, shape, torch.device(dev), dtype)
            first, losses = None, []
            tic = time.perf_counter()
            for i in range(steps):
                x, labels = batches[i % len(batches)]
                losses.append(step(x.to(dev, dtype), labels.to(dev)))
                if i == 0:
                    first = leaves_of(params)
            snaps[name] = {"first": first, "last": leaves_of(params),
                           "losses": losses,
                           "seconds": time.perf_counter() - tic}
    return snaps


def compare(rows, part, stack, snaps, steps):
    ref = snaps["cpu_f64"]
    for name in ("card_f32", "card_f32_deterministic", "cpu_f32"):
        errs = {when: rel_errs(snaps[name][when], ref[when])
                for when in ("first", "last")}
        emit(rows, {"part": part, "stack": stack, "run": name,
                    "against": "cpu_f64", "steps": steps,
                    "after_first": split_worst(errs["first"]),
                    "after_last": split_worst(errs["last"]),
                    "rel_err_by_leaf_last": errs["last"],
                    "losses_last": snaps[name]["losses"][-3:],
                    "seconds": snaps[name]["seconds"]})
    for a, b in (("card_f32", "cpu_f32"),
                 ("card_f32", "card_f32_deterministic")):
        errs = {when: rel_errs(snaps[a][when], snaps[b][when])
                for when in ("first", "last")}
        emit(rows, {"part": part, "stack": stack, "run": a, "against": b,
                    "steps": steps,
                    "after_first": split_worst(errs["first"]),
                    "after_last": split_worst(errs["last"])})


def steps_part(rows, steps):
    from veles_tpu_torch.samples import mnist_conv
    from veles_tpu_torch.samples.datasets import load_mnist
    tr_x, tr_y, _te_x, _te_y, _real = load_mnist()
    batches = [(torch.from_numpy(numpy.ascontiguousarray(
        tr_x[i:i + 100].reshape(-1, 28, 28, 1), dtype=numpy.float32)),
        torch.from_numpy(tr_y[i:i + 100].astype(numpy.int32)))
        for i in range(0, len(tr_x) - 99, 100)]
    for stack, layers in (("lenet", mnist_conv.LAYERS),
                          ("tie_free", tie_free(mnist_conv.LAYERS))):
        snaps = run_variants(layers, (28, 28, 1), batches, steps)
        compare(rows, "steps", stack, snaps, steps)


def alexnet_part(rows):
    from veles_tpu_torch.samples import alexnet
    x, labels = alexnet.synthetic_imagenet_batch(cs.ALEXNET_PARITY_BATCH)
    batches = [(torch.from_numpy(x), torch.from_numpy(labels))]
    snaps = run_variants(alexnet.LAYERS, alexnet.INPUT_SHAPE, batches, 1)
    compare(rows, "alexnet", "alexnet", snaps, 1)


def speed_part(rows, device):
    """AlexNet f32 at batch 128: images/s of the captured step with
    cuDNN as the port leaves it and deterministic, in turns."""
    from veles_tpu_torch.samples import alexnet
    for mode in ("default", "deterministic", "deterministic", "default"):
        with cudnn_mode(mode == "deterministic"):
            ips = alexnet.benchmark(batch=cs.ALEXNET_BATCH,
                                    steps=cs.ALEXNET_STEPS, device=device)
        emit(rows, {"part": "speed", "model": "alexnet", "dtype": "float32",
                    "batch": cs.ALEXNET_BATCH, "mode": mode,
                    "images_per_s": ips})
        torch.cuda.empty_cache()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=120)
    parser.add_argument("--epochs", type=int,
                        default=cs.MNIST_CONV_PARITY_EPOCHS)
    parser.add_argument("--parts",
                        default="workflow,steps,alexnet,speed")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("conv_drift_probe: no CUDA card", file=sys.stderr)
        return 2
    from veles_tpu_torch.backends import set_precision
    from veles_tpu_torch.config import root
    # full f32 in cuDNN and cuBLAS (TF32 off), as chip_smoke.py runs
    root.common.engine.precision_level = 2
    set_precision()
    device = torch.device("cuda", 0)
    rows = []
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    emit(rows, {"nvidia_smi": smi, "torch": torch.__version__,
                "cudnn": torch.backends.cudnn.version()})
    parts = args.parts.split(",")
    if "workflow" in parts:
        workflow_part(rows, device, args.epochs)
    if "steps" in parts:
        steps_part(rows, args.steps)
    if "alexnet" in parts:
        alexnet_part(rows)
    if "speed" in parts:
        speed_part(rows, device)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(r) for r in rows)
                                  + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
