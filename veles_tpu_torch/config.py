"""Auto-vivifying configuration tree (the ``root.*`` namespace).

The port's own copy of :mod:`veles_tpu.config` (the port imports nothing
of ``veles_tpu``): the same dotted namespace, trimmed to the defaults
the paths the port runs: ``root.common.engine`` (``trace``,
``precision_level``, ``precision_type``, ``pallas_reduce``, the
workflow's ``stitch``, ``loader``, ``epoch_scan`` and
``metrics_every``, and the job master's ``checkpoint``),
``root.common.chaos`` (the fault injection of the job layer) and the
``root.common.gen`` subtree (``kv``, ``prefill_chunk``,
``prefix_cache``, ``speculative``), which auto-vivifies.
:func:`update_from_arguments` applies the entry point's ``key=value``
overrides and :func:`apply_site_config` its site configuration files.
"""

import json
import os


class Config(object):
    """A node in the auto-vivifying config tree.

    Attribute access on a missing key creates a child ``Config`` node, so
    ``root.a.b.c = 1`` works with no prior declarations.
    """

    __slots__ = ("__dict__", "__path__")

    def __init__(self, path="root"):
        object.__setattr__(self, "__path__", path)

    def __getattr__(self, name):
        if name.startswith("__") and name.endswith("__"):
            raise AttributeError(name)
        child = Config("%s.%s" % (self.path, name))
        self.__dict__[name] = child
        return child

    def __setattr__(self, name, value):
        self.__dict__[name] = value

    @property
    def path(self):
        return object.__getattribute__(self, "__path__")

    def __contains__(self, name):
        return name in self.__dict__

    def __iter__(self):
        return iter(sorted(self.__dict__.items()))

    def __bool__(self):
        return bool(self.__dict__)

    def __repr__(self):
        return "<Config %s: %d keys>" % (self.path, len(self.__dict__))

    def get(self, name, default=None):
        """Non-vivifying lookup."""
        return self.__dict__.get(name, default)

    def update(self, tree):
        """Deep-merge a nested dict (or another Config) into this node."""
        if isinstance(tree, Config):
            tree = tree.to_dict()
        if not isinstance(tree, dict):
            raise TypeError("Config.update expects a dict, got %r" % tree)
        for key, value in tree.items():
            if isinstance(value, dict):
                node = self.__dict__.get(key)
                if not isinstance(node, Config):
                    node = Config("%s.%s" % (self.path, key))
                    self.__dict__[key] = node
                node.update(value)
            else:
                setattr(self, key, value)
        return self

    def to_dict(self):
        out = {}
        for key, value in self.__dict__.items():
            out[key] = value.to_dict() if isinstance(value, Config) else value
        return out

    def print_(self, indent=0, file=None):
        """Print the subtree, one key a line (``--dump-config``)."""
        import sys
        file = file or sys.stdout
        for key, value in sorted(self.__dict__.items()):
            if isinstance(value, Config):
                print("%s%s:" % ("  " * indent, key), file=file)
                value.print_(indent + 1, file)
            else:
                print("%s%s: %r" % ("  " * indent, key, value), file=file)


#: The global configuration tree.
root = Config("root")

root.common.update({
    "engine": {
        # Unified tracing (veles_tpu_torch.trace): "off" (every hook is
        # a single attribute check) or "on" (record spans into the ring).
        "trace": "off",
        # Float32 matmul precision of the library and plain paths
        # (veles_tpu_torch.backends.set_precision, applied whenever an
        # entry point resolves a card): 0 lets cuBLAS and cuDNN use
        # TF32, 1 and 2 keep full float32.
        "precision_level": 0,
        # The compute dtype of the fused trainer's products
        # (veles_tpu_torch.backends.Device.compute_dtype): "float32", or
        # "bfloat16" for bf16 operands with f32 sums and f32 master
        # weights and momenta.  Only the fused path reads it.
        "precision_type": "float32",
        # matrix_reduce through its kernel (veles_tpu_torch.ops.reduce)
        # instead of torch's own reduction.
        "pallas_reduce": False,
        # Segment stitching (veles_tpu_torch.stitch): "on" runs each
        # maximal chain of stitchable units as one segment (one CUDA
        # graph on the card), "off" the eager per-unit chain.
        "stitch": "on",
        # FullBatchLoader minibatch selection: "auto" and "device" let
        # the loader head the first stitched segment (the gather runs
        # inside it), "host" keeps the loader a per-unit barrier.
        "loader": "auto",
        # K-step epoch windows (veles_tpu_torch.epoch_scan): "off" (one
        # dispatch a segment a step), "auto" (K = metrics_every when
        # set, else 1024) or an integer K; a window is one CUDA graph
        # on the card and never crosses a class close.
        "epoch_scan": "off",
        # Kernel backend: "auto" and "pallas" take the hand-written
        # kernels; "xla" (the dense escape hatch of the transformer's
        # attention and the GD units) raises (ROADMAP item 7).
        "kernels": "auto",
        # The Decision's metric fetch every K steps (0: one fetch a
        # class end); it also bounds an epoch-scan window.
        "metrics_every": 0,
        # Trace ring capacity in events; wraparound keeps the newest
        # (read by veles_tpu_torch.trace.configure).
        "trace_capacity": 65536,
        # Training-health statistics in the stitched segments and
        # windows: "off" | "on" | "strict" (veles_tpu_torch.watch.health)
        "health": "off",
        # The job master's crash recovery
        # (veles_tpu_torch.parallel.jobs.JobServer): a non-empty "dir"
        # checkpoints the workflow's train state there every
        # "every_jobs" applied updates and at every epoch boundary.
        "checkpoint": {"dir": "", "every_jobs": 0},
    },
    # Deterministic fault injection (veles_tpu_torch.chaos, read at
    # chaos.configure(), which the Launcher calls at initialize):
    # "schedule" is a list of fault dicts or the path of a JSON file of
    # them; a run replays from (seed, schedule).
    "chaos": {
        "enabled": False,
        "seed": 1234,
        "schedule": [],
        "drop_probability": 0.0,
        "dup_probability": 0.0,
        "delay_probability": 0.0,
        "delay_ms": 50.0,
        "corrupt_probability": 0.0,
        "slave_death_probability": 0.0,
    },
    # Generative serving defaults (veles_tpu_torch.gen.engine); an
    # engine's keyword arguments win over them.
    "gen": {
        # "contiguous" (a max_seq slot a sequence) or "paged" (the
        # shared block pool)
        "kv": "contiguous",
        # paged: tokens per page (must divide max_seq) and pages in the
        # pool (None: every slot's max_seq, plus the trash block)
        "block_size": 16,
        "num_blocks": None,
        # tokens per prefill chunk (None: whole-prompt buckets)
        "prefill_chunk": None,
        # "on" shares full prompt pages between admissions (paged only)
        "prefix_cache": "off",
        # "off", "ngram" or a registered draft model's name, and the
        # drafted tokens a slot verifies per step (1..7)
        "speculative": "off",
        "draft_k": 4,
    },
})


def apply_site_config():
    """Exec each site configuration file against ``root``: a
    ``site_config.py`` beside the package, then the file named by
    ``$VELES_TPU_TORCH_SITE_CONFIG``."""
    candidates = [
        os.path.join(os.path.dirname(__file__), "site_config.py"),
        os.environ.get("VELES_TPU_TORCH_SITE_CONFIG", ""),
    ]
    for path in candidates:
        if path and os.path.exists(path):
            with open(path, "r") as fin:
                code = compile(fin.read(), path, "exec")
            exec(code, {"root": root})


def update_from_arguments(pairs):
    """Apply ``key=value`` overrides: ``key`` is a dotted path below
    ``root`` (a leading ``root.`` is allowed); ``value`` is parsed as
    JSON when it can be, else kept as a string."""
    for pair in pairs:
        key, sep, raw = pair.partition("=")
        if not sep:
            raise ValueError("override %r is not key=value" % pair)
        try:
            value = json.loads(raw)
        except ValueError:
            value = raw
        node = root
        parts = key.split(".")
        if parts[0] == "root":
            parts = parts[1:]
        if not parts:
            raise ValueError("override %r names no key below root" % pair)
        for part in parts[:-1]:
            node = getattr(node, part)
        setattr(node, parts[-1], value)
