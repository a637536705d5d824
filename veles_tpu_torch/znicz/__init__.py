"""Znicz neural-network units: the port's counterpart of
:mod:`veles_tpu.znicz`, ported so far for the fully-connected layers
(:mod:`.all2all`, :mod:`.gd`), the softmax evaluator, ``DecisionGD``
and the eager ``StandardWorkflow``."""
