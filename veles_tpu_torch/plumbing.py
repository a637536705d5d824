"""Control plumbing pseudo-units: the port's counterpart of
:mod:`veles_tpu.plumbing`.

``StartPoint`` fires the graph; ``EndPoint`` signals the workflow's
completion; ``Repeater`` is the loop anchor — it ignores its gate so the
back edge from the loop body re-fires it.
"""

from veles_tpu_torch.units import Unit


class Repeater(Unit):
    """Loop anchor: any single fired incoming edge re-fires the loop
    body."""

    hide_from_registry = False

    def __init__(self, workflow, **kwargs):
        super(Repeater, self).__init__(workflow, **kwargs)
        self.ignores_gate = True

    def open_gate(self, src):
        self.reset_gate()
        return True


class StartPoint(Unit):
    """The workflow's entry unit."""

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("name", "Start")
        super(StartPoint, self).__init__(workflow, **kwargs)


class EndPoint(Unit):
    """The workflow's exit unit: running it finishes the workflow."""

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("name", "End")
        super(EndPoint, self).__init__(workflow, **kwargs)

    def run(self):
        wf = self.workflow
        if wf is not None:
            wf.on_workflow_finished()

    def run_dependent(self):
        pass
