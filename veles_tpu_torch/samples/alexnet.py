"""AlexNet through the fused lowering: the port's counterpart of
:mod:`veles_tpu.samples.alexnet`.

The stack follows Krizhevsky et al. 2012 (five convs, LRN after the
first two, max pooling, dropout before the two 4096-wide layers, the
1000-way softmax) as StandardWorkflow layer specs, and
:func:`build_fused` lowers it (:func:`~veles_tpu_torch.znicz.fused_graph
.lower_specs`) into a train step whose three fully-connected layers run
on the GEMM kernel forward and in both backward products (nine launches
a step) and whose convs run on cuDNN.  The step is a
:class:`~veles_tpu_torch.znicz.fused_unit.GraphStep`: one CUDA graph a
batch shape, as the fused trainer captures its steps, after one eager
call.  ImageNet is not shipped: :func:`synthetic_imagenet_batch` gives
the JAX package's shape-true stand-in batches (images/s does not depend
on the data).  ``mesh=`` (a :class:`~veles_tpu_torch.parallel.mesh.Mesh`
with a ``data`` axis) trains data-parallel over its ranks: each takes
its contiguous rows of the global batch and the step averages the
gradients over the axis in one all-reduce inside its graph.  Run it
with

    python -m veles_tpu_torch.samples.alexnet [--device cpu] [--batch B]
        [--steps N] [--bf16]

which prints the images per second of the train step.
"""

import argparse
import json
import sys
import time

import numpy

LAYERS = [
    {"type": "conv_strict_relu",
     "->": {"n_kernels": 96, "kx": 11, "ky": 11, "sliding": (4, 4),
            "weights_filling": "gaussian", "weights_stddev": 0.01},
     "<-": {"learning_rate": 0.01, "gradient_moment": 0.9,
            "weights_decay": 0.0005}},
    {"type": "lrn", "->": {"alpha": 1e-4, "beta": 0.75, "n": 5,
                           "k": 2.0}},
    {"type": "max_pooling", "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
    {"type": "conv_strict_relu",
     "->": {"n_kernels": 256, "kx": 5, "ky": 5, "padding": 2,
            "weights_filling": "gaussian", "weights_stddev": 0.01},
     "<-": {"learning_rate": 0.01, "gradient_moment": 0.9,
            "weights_decay": 0.0005}},
    {"type": "lrn", "->": {"alpha": 1e-4, "beta": 0.75, "n": 5,
                           "k": 2.0}},
    {"type": "max_pooling", "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
    {"type": "conv_strict_relu",
     "->": {"n_kernels": 384, "kx": 3, "ky": 3, "padding": 1,
            "weights_filling": "gaussian", "weights_stddev": 0.01},
     "<-": {"learning_rate": 0.01, "gradient_moment": 0.9,
            "weights_decay": 0.0005}},
    {"type": "conv_strict_relu",
     "->": {"n_kernels": 384, "kx": 3, "ky": 3, "padding": 1,
            "weights_filling": "gaussian", "weights_stddev": 0.01},
     "<-": {"learning_rate": 0.01, "gradient_moment": 0.9,
            "weights_decay": 0.0005}},
    {"type": "conv_strict_relu",
     "->": {"n_kernels": 256, "kx": 3, "ky": 3, "padding": 1,
            "weights_filling": "gaussian", "weights_stddev": 0.01},
     "<-": {"learning_rate": 0.01, "gradient_moment": 0.9,
            "weights_decay": 0.0005}},
    {"type": "max_pooling", "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
    {"type": "dropout", "->": {"dropout_ratio": 0.5}},
    {"type": "all2all_strict_relu",
     "->": {"output_sample_shape": 4096, "weights_filling": "gaussian",
            "weights_stddev": 0.005},
     "<-": {"learning_rate": 0.01, "gradient_moment": 0.9,
            "weights_decay": 0.0005}},
    {"type": "dropout", "->": {"dropout_ratio": 0.5}},
    {"type": "all2all_strict_relu",
     "->": {"output_sample_shape": 4096, "weights_filling": "gaussian",
            "weights_stddev": 0.005},
     "<-": {"learning_rate": 0.01, "gradient_moment": 0.9,
            "weights_decay": 0.0005}},
    {"type": "softmax",
     "->": {"output_sample_shape": 1000, "weights_filling": "gaussian",
            "weights_stddev": 0.01},
     "<-": {"learning_rate": 0.01, "gradient_moment": 0.9,
            "weights_decay": 0.0005}},
]

INPUT_SHAPE = (227, 227, 3)


def synthetic_imagenet_batch(batch, seed=0, shape=INPUT_SHAPE):
    """A shape-true stand-in batch: N(0, 1) images and labels in [0,
    1000), the JAX package's numpy draws."""
    rng = numpy.random.default_rng(seed)
    x = rng.standard_normal((batch,) + tuple(shape)).astype(numpy.float32)
    labels = rng.integers(0, 1000, batch).astype(numpy.int32)
    return x, labels


def build_fused(mesh=None, layers=None, input_shape=INPUT_SHAPE,
                compute_dtype=None, device=None, remat=False, grad_accum=1,
                fsdp=False):
    """``(params, step, eval, apply)``: the lowered stack's parameters as
    tensors on ``device`` (the card when None; raises without one), its
    train step as a :class:`~veles_tpu_torch.znicz.fused_unit.GraphStep`
    (``step(params, x, labels) -> (params, metrics)``, params updated in
    place), and the eval and apply functions.  ``compute_dtype=
    "bfloat16"``: bf16 products with f32 master weights.  With ``mesh``
    the step takes the GLOBAL batch on every rank and trains on the
    rank's rows of it (:func:`veles_tpu_torch.parallel.dp
    .data_parallel`); ``fsdp=True`` also stores every leaf of
    :func:`~veles_tpu_torch.parallel.dp.fsdp_rules` as the rank's slice
    over the data axis (the returned params are the slices)."""
    from veles_tpu_torch.backends import resolve_device
    from veles_tpu_torch.znicz.fused_graph import lower_specs, to_tensors
    from veles_tpu_torch.znicz.fused_unit import GraphStep, warm_up_group
    device = resolve_device(device)
    rules = None
    if fsdp:
        if mesh is None:
            raise ValueError("fsdp shards over a mesh: pass mesh too")
        from veles_tpu_torch.parallel.dp import fsdp_rules
        rules = fsdp_rules(mesh)
    params, step_fn, eval_fn, apply_fn = lower_specs(
        layers or LAYERS, input_shape, compute_dtype=compute_dtype,
        remat=remat, grad_accum=grad_accum,
        grad_reduce_axis="data" if mesh is not None else None, mesh=mesh,
        param_rules=rules)
    if rules is not None:
        from veles_tpu_torch.parallel.dp import shard_params
        params = shard_params(params, mesh, param_rules=rules)
    if mesh is not None:
        from veles_tpu_torch.parallel.dp import data_parallel
        step_fn = data_parallel(step_fn, mesh)
        warm_up_group(mesh.group("data"), device)
    return (to_tensors(params, device), GraphStep(step_fn), eval_fn,
            apply_fn)


def benchmark(batch=128, steps=10, mesh=None, layers=None,
              input_shape=INPUT_SHAPE, compute_dtype=None, device=None,
              build=build_fused):
    """Images per second of the fused train step: ``steps`` steps after
    the eager and the captured first two, on one device-resident batch."""
    import torch
    params, step, _eval, _apply = build(
        mesh=mesh, layers=layers, input_shape=input_shape,
        compute_dtype=compute_dtype, device=device)
    x, labels = synthetic_imagenet_batch(batch, shape=input_shape)
    dev = params[0]["w"].device
    x = torch.from_numpy(x).to(dev)
    labels = torch.from_numpy(labels).to(dev)
    for _ in range(2):
        step(params, x, labels)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    tic = time.perf_counter()
    for _ in range(steps):
        step(params, x, labels)
    sync()
    return steps * batch / (time.perf_counter() - tic)


def main(argv=None, module="alexnet", default_batch=128, bench=None):
    parser = argparse.ArgumentParser(
        prog="python -m veles_tpu_torch.samples.%s" % module,
        description="Time the fused train step.")
    parser.add_argument("--device", default=None,
                        help="cpu, or a cuda device (default: the card)")
    parser.add_argument("--batch", type=int, default=default_batch)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--bf16", action="store_true",
                        help="bf16 products, f32 master weights")
    args = parser.parse_args(argv)
    rate = (bench or benchmark)(
        batch=args.batch, steps=args.steps, device=args.device,
        compute_dtype="bfloat16" if args.bf16 else None)
    print(json.dumps({"model": module, "batch": args.batch,
                      "images_per_s": rate}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
