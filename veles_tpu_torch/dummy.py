"""Test fakes: the port's counterpart of :mod:`veles_tpu.dummy`.
``DummyLauncher`` lets a workflow run standalone with no real launcher;
``DummyWorkflow`` is a workflow pre-wired to one."""

from veles_tpu_torch.logger import Logger
from veles_tpu_torch.workflow import Workflow


class DummyLauncher(Logger):
    """The launcher interface a standalone workflow consults."""

    def __init__(self, **kwargs):
        super(DummyLauncher, self).__init__()
        self.is_master = kwargs.get("is_master", False)
        self.is_slave = kwargs.get("is_slave", False)
        self.is_standalone = not (self.is_master or self.is_slave)
        self.stopped = False
        self.workflow = None

    def add_ref(self, workflow):
        self.workflow = workflow

    def del_ref(self, workflow):
        pass

    def on_workflow_finished(self):
        self.stopped = True

    def stop(self):
        self.stopped = True


class DummyWorkflow(Workflow):
    """A workflow pre-wired to a DummyLauncher."""

    def __init__(self, **kwargs):
        super(DummyWorkflow, self).__init__(None, **kwargs)
        self.launcher = DummyLauncher(
            is_master=kwargs.get("is_master", False),
            is_slave=kwargs.get("is_slave", False))
