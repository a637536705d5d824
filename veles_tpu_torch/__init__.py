"""veles_tpu_torch — the PyTorch + CUDA port of veles_tpu.

A package of its own beside :mod:`veles_tpu`, which stays the reference
the port is held against.  It imports ``torch`` and numpy, never
``jax`` and never a module of ``veles_tpu``: what it needs from there
it keeps as its own copy, under the same module name, so a reader finds
each counterpart.  Every TPU kernel on a ported path is a kernel written
by hand for the H100 (``csrc/``), with its plain PyTorch version beside
it (``ops/``).

Ported so far: generative serving of the transformer LM with a
contiguous KV cache (:mod:`veles_tpu_torch.gen`), single-card training
of the same LM (:mod:`veles_tpu_torch.samples.transformer`), and
training of the MNIST MLP through the unit/workflow core
(:mod:`veles_tpu_torch.samples.mnist` over :mod:`.units`,
:mod:`.workflow`, :mod:`.memory`, :mod:`.loader` and :mod:`.znicz`),
with its whole-workflow snapshots and train-state checkpoints
(:mod:`.snapshotter`, :mod:`.checkpoint`), and master/slave training
over the job layer (:mod:`.parallel.jobs`) from the entry point,
``python -m veles_tpu_torch <workflow> [-l HOST:PORT | -m HOST:PORT]``
(:mod:`.__main__`, :mod:`.launcher`).  Entry points run on the CUDA card
unless the caller passes ``device="cpu"`` (``-d cpu``).
"""

__version__ = "0.1.0"
