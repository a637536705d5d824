"""``python -m veles_tpu_torch <workflow> [<config>] [key=value ...]``: the
entry point, the port's counterpart of :mod:`veles_tpu.__main__`.

Parse the arguments, seed the named random streams (``-r``), load the
workflow module (a dotted name or a file), exec the config file against
``root.*`` and apply the ``key=value`` overrides, construct the
:class:`~veles_tpu_torch.launcher.Launcher` and the workflow, initialize
and run.  A workflow module follows one of two conventions:

- ``create_workflow(launcher=..., **kwargs) -> workflow``, the samples'
  (:mod:`veles_tpu_torch.samples`): given a launcher, the module leaves
  ``initialize`` to it;
- ``run(load, main)``: the module calls ``load(WorkflowClass,
  **kwargs)`` to construct and ``main(**kwargs)`` to initialize and run.

``-w`` resumes a snapshot (:func:`veles_tpu_torch.snapshotter
.load_snapshot`).  The run is on the card unless ``-d cpu``; without a
card it raises.  ``-l HOST:PORT`` makes a master, ``-m HOST:PORT`` a
slave, and ``-n`` bootstraps slaves from the master (``--slave-launch-
transform 'sh -c'`` runs them on this host).  ``--profile DIR`` turns
the span recorder on and writes its Chrome trace there at the end, and
a master also writes the session profile bundle of its slaves
(``session_profile.json``).  The flags of modules not ported yet raise
``NotImplementedError`` naming ROADMAP item 7(e).
"""

import importlib
import importlib.util
import logging
import os
import sys

from veles_tpu_torch import prng
from veles_tpu_torch.cmdline import html_reference, make_parser
from veles_tpu_torch.config import (
    apply_site_config, root, update_from_arguments)
from veles_tpu_torch.launcher import Launcher
from veles_tpu_torch.logger import Logger

#: (argument dest, flag) of the modules the port does not have yet
NOT_PORTED = (
    ("optimize", "--optimize"),
    ("ensemble_train", "--ensemble-train"),
    ("ensemble_test", "--ensemble-test"),
    ("visualize", "--visualize"),
    ("graphics", "-p/--graphics"),
    ("web_status", "--web-status"),
    ("analyze", "--analyze"),
    ("workflow_graph", "--workflow-graph"),
    ("manhole", "--manhole"),
    ("frontend", "--frontend"),
    ("log_db", "--log-db"),
    ("debug_nans", "--debug-nans"),
)

_peak_printer_registered = False


class Main(Logger):
    """One invocation of the entry point."""

    def __init__(self, argv=None):
        super(Main, self).__init__()
        self.argv = list(sys.argv[1:] if argv is None else argv)
        self.args = None
        self.launcher = None
        self.workflow = None
        self.module = None

    # -- setup --------------------------------------------------------------
    def _parse(self):
        parser = make_parser()
        args, extra = parser.parse_known_args(self.argv)
        # argparse leaves stray key=value positionals in `extra` or in
        # `config`: they are overrides
        overrides = list(args.overrides)
        for item in extra:
            if "=" in item and not item.startswith("-"):
                overrides.append(item)
            else:
                parser.error("unrecognized argument: %s" % item)
        if args.config and "=" in args.config and \
                not os.path.exists(args.config):
            overrides.insert(0, args.config)
            args.config = None
        args.overrides = overrides
        self.args = args
        return args

    def _refuse_not_ported(self):
        for dest, flag in NOT_PORTED:
            if getattr(self.args, dest, None):
                raise NotImplementedError(
                    "%s is not ported yet (ROADMAP item 7(e))" % flag)

    def _setup_logging(self):
        level = getattr(logging, self.args.verbosity.upper())
        logging.basicConfig(level=level)
        logging.getLogger().setLevel(level)
        for name in filter(None, self.args.debug.split(",")):
            logging.getLogger(name).setLevel(logging.DEBUG)

    def _seed_random(self):
        """Seed every named stream: ``-r`` an int, or
        ``path[:dtype[:count]]`` of a seed file; 1234 without it."""
        spec = self.args.random_seed
        if spec is None:
            prng.seed_all(1234)
            return
        try:
            prng.seed_all(int(spec))
            return
        except ValueError:
            pass
        parts = spec.split(":")
        path, dtype, count = (
            parts[0],
            parts[1] if len(parts) > 1 else "uint32",
            int(parts[2]) if len(parts) > 2 else 16)
        import numpy
        with open(path, "rb") as fin:
            raw = numpy.frombuffer(
                fin.read(numpy.dtype(dtype).itemsize * count),
                dtype=dtype, count=count)
        prng.seed_all(int(numpy.sum(raw.astype(numpy.uint64)) % (2 ** 31)))

    def _apply_config(self):
        """Exec the site configuration, the config file, then the
        overrides against ``root``."""
        apply_site_config()
        if self.args.config:
            with open(self.args.config, "r") as fin:
                code = compile(fin.read(), self.args.config, "exec")
            exec(code, {"root": root})
        if self.args.overrides:
            update_from_arguments(self.args.overrides)

    # -- the workflow ---------------------------------------------------------
    def _load_module(self, spec):
        """A workflow module from a file path or a dotted name."""
        if os.path.exists(spec):
            name = os.path.splitext(os.path.basename(spec))[0]
            modspec = importlib.util.spec_from_file_location(name, spec)
            module = importlib.util.module_from_spec(modspec)
            sys.modules[name] = module
            modspec.loader.exec_module(module)
            return module
        return importlib.import_module(spec)

    def _launcher_kwargs(self):
        args = self.args
        kwargs = {
            "listen": args.listen,
            "master_address": args.master_address,
            "device": args.device,
            "testing": args.test,
            "nodes": args.nodes,
            "yarn": args.yarn,
            "slave_launch_transform": args.slave_launch_transform,
            "checkpoint_dir": args.checkpoint_dir,
            "checkpoint_every": args.checkpoint_every,
            "resume": args.resume,
        }
        if args.profile and args.listen:
            kwargs["session_profile"] = os.path.join(
                args.profile, "session_profile.json")
        return kwargs

    def _construct(self):
        """The launcher and the workflow, from the module or a
        snapshot."""
        launcher_kwargs = self._launcher_kwargs()
        if self.args.snapshot:
            from veles_tpu_torch.snapshotter import load_snapshot
            self.workflow = load_snapshot(self.args.snapshot)
            self.launcher = Launcher(self.workflow, **launcher_kwargs)
            self.info("resumed workflow from %s", self.args.snapshot)
            return
        if not self.args.workflow:
            raise SystemExit("no workflow given (and no --snapshot)")
        self.module = self._load_module(self.args.workflow)
        if hasattr(self.module, "run"):
            self._construct_via_run(launcher_kwargs)
        elif hasattr(self.module, "create_workflow"):
            self.launcher = Launcher(**launcher_kwargs)
            extra = {"fused": True} if self.args.fused else {}
            self.workflow = self.module.create_workflow(
                launcher=self.launcher, **extra)
            if self.workflow.launcher is not self.launcher:
                self.workflow.launcher = self.launcher
        else:
            raise SystemExit(
                "workflow module %r defines neither run(load, main) nor "
                "create_workflow(...)" % self.args.workflow)

    def _construct_via_run(self, launcher_kwargs):
        """The ``run(load, main)`` convention."""
        main_self = self

        def load(workflow_class, **kwargs):
            main_self.launcher = Launcher(**launcher_kwargs)
            if main_self.args.fused:
                kwargs.setdefault("fused", True)
            wf = workflow_class(main_self.launcher, **kwargs)
            # the launcher given as the parent registered the workflow;
            # the workflow reads its mode through its own launcher
            if wf.launcher is not main_self.launcher:
                wf.launcher = main_self.launcher
            main_self.workflow = wf
            return wf, None

        def main(**kwargs):
            main_self.launcher.initialize(**kwargs)
            if not main_self.args.dry_run:
                main_self.launcher.run()

        self.module.run(load, main)

    @staticmethod
    def print_peak_memory():
        """The process's peak resident memory (and the card's peak
        allocation when it used one), at exit."""
        import resource
        peak_kib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        print("Peak resident memory: %.1f MiB" % (peak_kib / 1024.0),
              file=sys.stderr)
        torch = sys.modules.get("torch")
        if torch is not None and torch.cuda.is_available() \
                and torch.cuda.is_initialized():
            print("Peak device memory allocated: %.1f MiB"
                  % (torch.cuda.max_memory_allocated() / 2.0 ** 20),
                  file=sys.stderr)

    @staticmethod
    def _version_line():
        import torch

        import veles_tpu_torch
        return "veles_tpu_torch %s (torch %s, cuda %s, python %d.%d)" % (
            veles_tpu_torch.__version__, torch.__version__,
            torch.version.cuda, sys.version_info[0], sys.version_info[1])

    def _dump_unit_attributes(self, mode):
        """Print every unit's attributes after initialization;
        ``pretty`` elides arrays and tensors of more than 16 values."""
        import numpy
        import torch

        for unit in self.workflow:
            attrs = {}
            for key, value in sorted(vars(unit).items()):
                if key.endswith("_"):
                    continue
                if mode == "pretty" and isinstance(
                        value, (numpy.ndarray, torch.Tensor)) \
                        and int(numpy.prod(tuple(value.shape))) > 16:
                    value = "<%s array %s>" % (
                        value.dtype, "x".join(map(str, value.shape)))
                attrs[key] = value
            print("%s: %s" % (unit.name or type(unit).__name__, attrs))

    def _daemonize(self):
        """Double-fork into the background (``-b``)."""
        if os.fork() > 0:
            os._exit(0)
        os.setsid()
        if os.fork() > 0:
            os._exit(0)
        devnull = os.open(os.devnull, os.O_RDWR)
        for fd in (0, 1):
            os.dup2(devnull, fd)
        self.info("daemonized (pid %d)", os.getpid())

    # -- run ----------------------------------------------------------------
    def run(self):
        args = self._parse()
        if args.version:
            print(self._version_line())
            return 0
        if args.html_help:
            import tempfile
            fd, path = tempfile.mkstemp(suffix=".html",
                                        prefix="veles_tpu_torch_help_")
            with os.fdopen(fd, "w") as fout:
                fout.write(html_reference())
            print("argument reference written to %s" % path)
            return 0
        self._refuse_not_ported()
        if not args.no_logo:
            print(self._version_line(), file=sys.stderr)
        global _peak_printer_registered
        if not _peak_printer_registered:
            _peak_printer_registered = True
            import atexit
            atexit.register(self.print_peak_memory)
        if args.background:
            self._daemonize()
        self._setup_logging()
        if args.debug_pickle:
            from veles_tpu_torch import snapshotter
            snapshotter.DEBUG_PICKLE = True
            self.info("pickle diagnostics enabled")
        self._seed_random()
        self._apply_config()
        # a seed in the config counts unless -r gave one
        cfg_seed = root.common.engine.get("seed", None)
        if cfg_seed is not None and args.random_seed is None:
            prng.seed_all(int(cfg_seed))
        if args.dump_config:
            root.print_()
        if args.dry_run == "load":
            self.info("dry run (load) complete")
            return 0
        if args.profile:
            os.makedirs(args.profile, exist_ok=True)
            # read by trace.configure() at Workflow.initialize
            root.common.engine.trace = "on"
        try:
            return self._run_constructed(args)
        finally:
            if args.profile:
                self._save_trace(args.profile)

    def _save_trace(self, directory):
        from veles_tpu_torch import trace
        mode = self.launcher.mode if self.launcher is not None \
            else "standalone"
        path = os.path.join(directory, "trace_%s_%d.json"
                            % (mode, os.getpid()))
        trace.save(path)
        self.info("trace written to %s", path)

    def _run_constructed(self, args):
        self._construct()
        if args.result_file:
            self.workflow.result_file = args.result_file
        if self.workflow is not None \
                and not getattr(self.workflow, "_is_initialized", False) \
                and self.launcher is not None:
            self.launcher.initialize()
        if args.dump_unit_attributes != "no" and self.workflow is not None:
            self._dump_unit_attributes(args.dump_unit_attributes)
        if args.dry_run:
            self.info("dry run (%s) complete", args.dry_run)
            return 0
        if self.module is None or not hasattr(self.module, "run"):
            # the run(load, main) convention ran inside _construct
            self.launcher.run()
        # a slave's results are its master's
        if args.result_file and self.workflow is not None \
                and not self.launcher.is_slave:
            self.workflow.write_results(args.result_file)
        return 0


def __run__():
    sys.exit(Main().run())


if __name__ == "__main__":
    __run__()
