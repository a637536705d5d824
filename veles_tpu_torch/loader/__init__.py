"""Loaders: the port's counterpart of :mod:`veles_tpu.loader`, ported so
far for the resident full-batch case (:mod:`.base`, :mod:`.fullbatch`)."""
