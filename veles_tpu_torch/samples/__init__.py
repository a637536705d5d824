"""Model configurations and parameter layouts of the port.

A sample's ``create_workflow(..., launcher=None)`` builds its workflow;
:func:`launch` then either attaches the given launcher and leaves
``initialize`` to it (``python -m veles_tpu_torch``'s Launcher picks the
device and the mode), or initializes it standalone on ``device`` (the
card when None, raising without one).
"""


def launch(workflow, launcher, device):
    """Attach ``launcher`` to ``workflow`` and return it uninitialized;
    without one, attach a ``DummyLauncher`` and initialize on
    ``device``."""
    if launcher is not None:
        workflow.launcher = launcher
        return workflow
    from veles_tpu_torch.backends import make_device
    from veles_tpu_torch.dummy import DummyLauncher
    workflow.launcher = DummyLauncher()
    workflow.initialize(device=make_device(device))
    return workflow
