"""Utility scripts: the port's counterpart of :mod:`veles_tpu.scripts`.
Ported: snapshot diffing (:mod:`.compare_snapshots`) and the SPMD fleet
boot (:mod:`.spmd_launch`)."""
