"""Evaluators: the port's counterpart of :mod:`veles_tpu.znicz.evaluator`
(``EvaluatorSoftmax`` and ``EvaluatorMSE``).

``EvaluatorSoftmax`` emits ``err_output`` = δ = (y − onehot(label)) for
the gradient chain and the minibatch's ``n_err`` (mis-argmax count),
``loss`` (mean cross-entropy) and confusion matrix.  ``cuda_run`` is
:func:`_softmax_eval_math` in torch over the full padded buffers: rows
with label < 0 (the short batch's padding) are masked out, ``n_err`` and
``loss`` stay device scalars (the Decision fetches them once per class
end) and the confusion matrix accumulates on the device.  The stitched
stage runs the same math with the confusion matrix donated and
``n_err``/``loss`` as the segment's metrics.

``EvaluatorMSE`` emits δ = (y − target) on the minibatch's first
``batch`` rows and the minibatch's metric ``mse``: the mean over those
rows of each row's root mean square error (``root=False``: its mean
square), computed with the JAX package's per-row max-abs rescale
(:func:`_mse_eval_math`), so the squares stay within [0, 1].
``mean=False`` scales δ by the buffer's rows (the GD units then sum
over the batch instead of averaging).  The stitched stage reads
``batch`` as a float scalar of the segment's block.  The JAX package's
float64 ``numpy_run`` is not ported: on the CPU the same torch math
runs over CPU tensors.
"""

import numpy
import torch

from veles_tpu_torch.accelerated_units import AcceleratedUnit
from veles_tpu_torch.memory import Vector


def _softmax_eval_math(out, labels, max_idx, confusion, group=None):
    """Mirror of ``_softmax_eval_math``: ``(err, n_err, loss,
    confusion)``; ``confusion`` (classes, classes) int64 is updated in
    place when given.  ``group`` (a pod's data group; each rank holds
    its own rows) sums ``n_err``, the loss's sum and valid rows (one
    all-reduce) and the confusion counts (another) over the group, so
    every rank holds the global values."""
    out32 = out.float()
    valid = labels >= 0
    lbl = labels.clamp(min=0).long()
    onehot = torch.nn.functional.one_hot(lbl, out.shape[1]).float()
    err = torch.where(valid[:, None], out32 - onehot,
                      torch.zeros_like(out32))
    pred = max_idx.long()
    n_err = ((pred != labels.long()) & valid).sum()
    probs = out32.gather(1, lbl[:, None])[:, 0]
    n_valid = valid.sum()
    loss_sum = -(torch.log(probs.clamp(min=1e-30)) * valid).sum()
    if group is not None:
        from veles_tpu_torch.parallel.comm import all_reduce
        # counts below 2**24 stay exact in float32
        sums = all_reduce(torch.stack([loss_sum, n_valid.float(),
                                       n_err.float()]), group)
        loss_sum = sums[0]
        n_valid = sums[1].to(n_valid.dtype)
        n_err = sums[2].to(n_err.dtype)
    loss = torch.where(
        n_valid > 0, loss_sum / n_valid.clamp(min=1),
        torch.zeros((), dtype=torch.float32, device=out.device))
    if confusion is not None:
        # integer counts: the order of the adds does not matter
        n = confusion.shape[1]
        if group is None:
            confusion.view(-1).index_add_(0, lbl * n + pred,
                                          valid.to(confusion.dtype))
        else:
            delta = torch.zeros_like(confusion)
            delta.view(-1).index_add_(0, lbl * n + pred,
                                      valid.to(confusion.dtype))
            confusion.add_(all_reduce(delta, group))
    return err, n_err, loss, confusion


def _mse_eval_math(out, target, batch):
    """Mirror of ``_mse_eval_math``: ``(err, mean_sq_scaled,
    row_scale, valid)`` for the first ``batch`` rows (a number or a 0-d
    tensor); each row's error is rescaled by its largest magnitude
    before it is squared."""
    rows = out.shape[0]
    out32 = out.reshape(rows, -1).float()
    t32 = target.reshape(rows, -1).float()
    valid = torch.arange(rows, device=out.device) < batch
    err = torch.where(valid[:, None], out32 - t32,
                      torch.zeros((), dtype=torch.float32,
                                  device=out.device))
    scale = torch.clamp(err.abs().amax(dim=1, keepdim=True), min=1e-30)
    mean_sq_scaled = ((err / scale) ** 2).mean(dim=1)
    return err, mean_sq_scaled, scale[:, 0], valid


class EvaluatorBase(AcceleratedUnit):
    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        super(EvaluatorBase, self).__init__(workflow, **kwargs)
        self.output = None           # linked from the last forward
        self.err_output = Vector()
        self.batch_size = None       # linked from loader minibatch_size
        self.demand("output", "batch_size")

    def initialize(self, device=None, **kwargs):
        super(EvaluatorBase, self).initialize(device=device, **kwargs)
        self.err_output.reset(numpy.zeros(self.output.shape,
                                          dtype=numpy.float32))
        self.err_output.initialize(self.device)


class EvaluatorSoftmax(EvaluatorBase):
    """Cross-entropy on the softmax output."""

    def __init__(self, workflow, **kwargs):
        super(EvaluatorSoftmax, self).__init__(workflow, **kwargs)
        self.labels = None           # linked from loader minibatch_labels
        self.max_idx = None          # linked from All2AllSoftmax
        self.confusion_matrix = Vector()
        self.n_err = 0               # errors in the last minibatch
        self.loss = 0.0
        self.demand("labels", "max_idx")

    def initialize(self, device=None, **kwargs):
        super(EvaluatorSoftmax, self).initialize(device=device, **kwargs)
        n_classes = self.output.shape[1]
        self.confusion_matrix.reset(numpy.zeros(
            (n_classes, n_classes), dtype=numpy.int64))
        self.confusion_matrix.initialize(self.device)

    def cuda_run(self):
        err, self.n_err, self.loss, cm = _softmax_eval_math(
            self.output.devmem, self.labels.devmem, self.max_idx.devmem,
            self.confusion_matrix.devmem)
        self.err_output.devmem = err
        self.confusion_matrix.devmem = cm

    def stitch_stage(self):
        """The evaluator's math inside the forward segment: produces
        ``err_output``, updates the donated confusion matrix and
        publishes ``n_err`` and ``loss`` as device scalars."""
        from veles_tpu_torch.stitch import StitchStage
        if not isinstance(self.labels, Vector) \
                or not isinstance(self.max_idx, Vector):
            return None

        def fn(t):
            err, n_err, loss, cm = _softmax_eval_math(
                t["output"], t["labels"], t["max_idx"], t["confusion"])
            return {"err_output": err, "n_err": n_err, "loss": loss,
                    "confusion": cm}

        return StitchStage(
            self, fn,
            consumes={"output": self.output, "labels": self.labels,
                      "max_idx": self.max_idx},
            produces={"err_output": self.err_output},
            donated={"confusion": self.confusion_matrix},
            metrics=("n_err", "loss"))

    def pod_stage_fn(self, stage, pod):
        """The stage over a pod rank's rows: the same math with the sums
        reduced over the data group."""
        group = pod.group

        def fn(t):
            err, n_err, loss, cm = _softmax_eval_math(
                t["output"], t["labels"], t["max_idx"], t["confusion"],
                group)
            return {"err_output": err, "n_err": n_err, "loss": loss,
                    "confusion": cm}
        return fn


class EvaluatorMSE(EvaluatorBase):
    """Mean-squared error against ``target`` (linked from the loader's
    ``minibatch_targets``): δ = (y − t); ``mse`` (also published as
    ``n_err``) per minibatch."""

    def __init__(self, workflow, **kwargs):
        super(EvaluatorMSE, self).__init__(workflow, **kwargs)
        self.target = None
        self.mse = 0.0
        self.n_err = 0
        self.root = kwargs.get("root", True)
        #: True: mean-over-batch gradients (the GD units divide by the
        #: batch); False: sum-over-batch, δ pre-scaled by the rows
        self.mean = kwargs.get("mean", True)
        self.demand("target")

    def _device_math(self, out, target, batch, first=0, group=None):
        """``(err_output, mse)`` for a batch of ``batch`` rows; a pod
        rank passes the index of its first row and the data group, which
        sums the rows' errors."""
        err, mean_sq_scaled, row_scale, valid = _mse_eval_math(
            out, target, batch - first if first else batch)
        if self.root:
            per_sample = row_scale * torch.sqrt(mean_sq_scaled)
        else:
            per_sample = row_scale * row_scale * mean_sq_scaled
        denom = torch.clamp(batch, min=1.0) \
            if isinstance(batch, torch.Tensor) else max(float(batch), 1.0)
        total = (per_sample * valid).sum()
        if group is not None:
            from veles_tpu_torch.parallel.comm import all_reduce
            total = all_reduce(total.reshape(1), group)[0]
        mse = total / denom
        if not self.mean:
            err = err * float(self.err_output.shape[0])
        return err.reshape((err.shape[0],) + self.err_output.shape[1:]), mse

    def cuda_run(self):
        err, mse = self._device_math(self.output.devmem,
                                     self.target.devmem,
                                     float(int(self.batch_size)))
        self.err_output.devmem = err
        self.mse = mse
        self.n_err = mse

    def stitch_stage(self):
        """The evaluator's math inside the forward segment: consumes the
        output and the targets, produces ``err_output``, publishes
        ``mse`` and ``n_err`` and reads ``batch`` from the segment's
        float block."""
        from veles_tpu_torch.stitch import StitchStage
        if not isinstance(self.target, Vector):
            return None
        unit = self

        def fn(t):
            err, mse = unit._device_math(t["output"], t["target"],
                                         t["batch"])
            return {"err_output": err, "mse": mse, "n_err": mse}

        return StitchStage(
            self, fn,
            consumes={"output": self.output, "target": self.target},
            produces={"err_output": self.err_output},
            scalars=lambda: {"batch": float(int(unit.batch_size))},
            metrics=("mse", "n_err"))

    def pod_stage_fn(self, stage, pod):
        """The stage over a pod rank's rows: its own rows of the batch,
        the errors summed over the data group."""
        unit, first, group = self, pod.row_start, pod.group

        def fn(t):
            err, mse = unit._device_math(t["output"], t["target"],
                                         t["batch"], first, group)
            return {"err_output": err, "mse": mse, "n_err": mse}
        return fn
