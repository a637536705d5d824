"""Node specifications of a fleet.  Counterpart of
:mod:`veles_tpu.launcher`, trimmed to :func:`parse_nodes`, which
:mod:`veles_tpu_torch.scripts.spmd_launch` reads; the Launcher itself
(modes, the workflow lifecycle, the master/slave fleet) is ROADMAP item
7(e)."""

import re


def parse_nodes(specs):
    """``host[:ssh_port][xN]`` specs → [(host, ssh_port, count)].

    The count may be glued to the port (``host:22x3``) or follow the
    host as ``host *3`` / ``host x3``, but never glued to a bare host
    name, where it would be ambiguous (``linux01`` is a host, not
    ``linu`` × 1)."""
    out = []
    for spec in specs:
        s = str(spec).strip()
        count = 1
        m = re.search(r"(?:\*|\s+x)\s*(\d+)$", s)
        if m:
            count = int(m.group(1))
            s = s[:m.start()].rstrip()
        host, sep, port_part = s.partition(":")
        ssh_port = 22
        if sep:
            pm = re.match(r"^(\d+)(?:x(\d+))?$", port_part)
            if not pm:
                raise ValueError("bad node spec %r "
                                 "(want host[:port][xN])" % (spec,))
            ssh_port = int(pm.group(1))
            if pm.group(2):
                count = int(pm.group(2))
        if not re.match(r"^[\w.\-]+$", host):
            raise ValueError("bad node spec %r "
                             "(want host[:port][xN])" % (spec,))
        out.append((host, ssh_port, count))
    return out
