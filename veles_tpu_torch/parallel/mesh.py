"""Meshes of named axes over the ranks of the default process group,
and the sharding helpers.  Counterpart of
:mod:`veles_tpu.parallel.mesh`.

Where a JAX mesh lays devices out on named axes, a port :class:`Mesh`
lays out the RANKS of ``torch.distributed``'s default group (one rank a
card), row-major over its axes: it has ``shape`` (an ordered dict of
axis sizes), this rank's ``coords`` and, for an axis or a set of axes,
the :class:`~veles_tpu_torch.parallel.comm.Group` of the ranks that
differ from this one only along them.  A sharding is a spec, as ``P(...)``
is: a tuple with, for each dim, an axis name, a tuple of axis names or
None.  :func:`shard` cuts this rank's slice of a global tensor,
:func:`unshard` all-gathers the slices back.

Without an initialized process group a mesh is a layout: one process,
every axis of size 1 (:func:`mesh_from_topology`'s single-device
fallback), no group and no collective.  ``Mesh(axes, world_size=n)``
lays out ``n`` ranks without a group, which is how the topology rules
are checked in one process.
"""

import math

import numpy
import torch.distributed as dist

from veles_tpu_torch.parallel.comm import Group, all_gather


class MeshTopologyError(ValueError):
    """A requested topology cannot be laid out on the ranks (the axis
    product does not divide the rank count, an unknown axis spelling, a
    zero or negative size)."""


#: long-form axis spellings accepted in topology strings and dicts
_AXIS_ALIASES = {"pipeline": "pipe", "pp": "pipe", "ep": "expert",
                 "tp": "model"}


def distributed():
    """True when ``torch.distributed`` has a default process group."""
    return dist.is_available() and dist.is_initialized()


class Mesh(object):
    """Named axes over the ranks ``0 .. size-1`` (see the module).
    ``world_size`` other than the default group's makes a layout without
    groups; a rank past the mesh's size has no ``coords``."""

    def __init__(self, axes, world_size=None):
        self.axis_names = tuple(axes)
        self.shape = {name: int(axes[name]) for name in self.axis_names}
        self.size = math.prod(self.shape.values())
        live = distributed() and world_size in (None, dist.get_world_size())
        self.world_size = (dist.get_world_size() if live
                           else int(world_size or 1))
        if self.size > self.world_size:
            raise MeshTopologyError("mesh %r needs %d ranks, have %d"
                                    % (self.shape, self.size,
                                       self.world_size))
        self.rank = dist.get_rank() if live else 0
        self.coords = None
        if self.rank < self.size:
            self.coords = {name: int(c) for name, c in zip(
                self.axis_names, numpy.unravel_index(
                    self.rank, tuple(self.shape.values())))}
        self.live = live
        self._groups = {}
        if live:
            # every rank makes every group, in the same order
            for name in self.axis_names:
                self.group(name)
            self.group(*self.axis_names)

    def __repr__(self):
        return "Mesh(%s, rank=%d)" % (self.shape, self.rank)

    def axis_size(self, *axes):
        return math.prod(self.shape.get(a, 1) for a in axes)

    def index(self, *axes):
        """This rank's row-major index along ``axes`` (0 on an axis the
        mesh lacks)."""
        out = 0
        for a in axes:
            out = out * self.shape.get(a, 1) + (
                self.coords.get(a, 0) if self.coords else 0)
        return out

    def group(self, *axes):
        """The :class:`Group` of the ranks that share this rank's
        coordinates off ``axes`` (in row-major order along them); None
        on a mesh without a process group.  Made at its first request:
        every rank must ask for the same groups in the same order."""
        axes = tuple(a for a in self.axis_names if a in axes)
        if not self.live:
            return None
        if axes not in self._groups:
            sizes = tuple(self.shape.values())
            grid = numpy.arange(self.size).reshape(sizes)
            moving = [self.axis_names.index(a) for a in axes]
            fixed = [i for i in range(len(sizes)) if i not in moving]
            grid = grid.transpose(fixed + moving).reshape(
                -1, math.prod(sizes[i] for i in moving))
            mine = None
            for ranks in grid.tolist():
                pg = dist.new_group(ranks)
                if self.rank in ranks:
                    mine = Group(pg, ranks)
            self._groups[axes] = mine
        return self._groups[axes]


def _parse_topology(topology):
    """Topology knob → ``{axis: size}``.  Accepted spellings: ``None`` /
    ``""`` / ``"auto"`` (all ranks on ``data``); an int or digit string
    (that many ``data`` shards); ``"DxM"`` (``{"data": D, "model": M}``);
    ``"data=2,pipeline=4"`` (any axes; ``pipeline``/``pp`` → ``pipe``,
    ``ep`` → ``expert``, ``tp`` → ``model``); a dict (a Config node's
    ``to_dict()`` included)."""
    if topology is None:
        return {"data": -1}
    if hasattr(topology, "to_dict"):
        topology = topology.to_dict()
    if isinstance(topology, dict):
        if not topology:
            return {"data": -1}
        return {_AXIS_ALIASES.get(str(k), str(k)): int(v)
                for k, v in topology.items()}
    if isinstance(topology, int):
        return {"data": int(topology)}
    text = str(topology).strip().lower()
    if text in ("", "auto"):
        return {"data": -1}
    if "=" in text:
        axes = {}
        for pair in text.split(","):
            name, _, size = pair.partition("=")
            name = _AXIS_ALIASES.get(name.strip(), name.strip())
            try:
                axes[name] = int(size)
            except ValueError:
                raise MeshTopologyError(
                    "cannot parse pod topology %r — axis pair %r is "
                    "not name=int" % (topology, pair))
        return axes
    parts = text.split("x")
    try:
        sizes = [int(p) for p in parts]
    except ValueError:
        raise MeshTopologyError(
            "cannot parse pod topology %r — want an int, 'DxM', "
            "'axis=size,…', 'auto', or {axis: size}" % (topology,))
    if len(sizes) == 1:
        return {"data": sizes[0]}
    if len(sizes) == 2:
        return {"data": sizes[0], "model": sizes[1]}
    raise MeshTopologyError(
        "pod topology %r has %d axes — only data[xmodel] is "
        "spellable as an 'x' string; spell more axes as "
        "'data=D,pipeline=S,expert=E' or pass {axis: size}"
        % (topology, len(sizes)))


def layout(topology, n, require=None):
    """The ``{axis: size}`` that :func:`mesh_from_topology` lays out on
    ``n`` ranks (the JAX function's rules and errors)."""
    axes = _parse_topology(topology)
    for name in require or ():
        axes.setdefault(name, 1)
    if n <= 1:
        return {name: 1 for name in axes} or {"data": 1}
    wild = [name for name, size in axes.items() if size == -1]
    if len(wild) > 1:
        raise MeshTopologyError(
            "pod topology %r has %d wildcard (-1) axes — at most one "
            "can absorb the remainder" % (axes, len(wild)))
    fixed = 1
    for name, size in axes.items():
        if size == -1:
            continue
        if size < 1:
            raise MeshTopologyError(
                "pod topology axis %r has size %d — sizes must be "
                "positive (-1 = absorb remainder)" % (name, size))
        fixed *= size
    if wild:
        if n % fixed:
            raise MeshTopologyError(
                "pod topology %r: fixed axis product %d does not "
                "divide %d attached devices (remainder %d) — the "
                "wildcard axis cannot absorb a fraction of a chip"
                % (axes, fixed, n, n % fixed))
        axes[wild[0]] = n // fixed
    elif fixed > n or n % fixed:
        raise MeshTopologyError(
            "pod topology %r: axis product %d does not divide %d "
            "attached devices (remainder %d) — match the attached "
            "topology, pick a divisor sub-mesh, or spell an axis as "
            "-1 to absorb the remainder"
            % (axes, fixed, n, n % fixed if fixed <= n else fixed - n))
    return axes


def mesh_from_topology(topology=None, world_size=None, require=None):
    """The mesh of the ``root.common.engine.pod.topology`` knob (read
    when ``topology`` is None) over the default group's ranks (or
    ``world_size`` ranks laid out without a group): every size checked,
    at most one ``-1`` wildcard, the product dividing the rank count
    (a smaller product is a sub-mesh of the leading ranks), and one
    rank a transparent mesh of 1-sized axes.  ``require``: axis names
    added with size 1 when the topology omits them."""
    if topology is None:
        from veles_tpu_torch.config import root
        node = root.common.engine.get("pod")
        topology = node.get("topology") if node else None
    if world_size is None:
        world_size = dist.get_world_size() if distributed() else 1
    return Mesh(layout(topology, world_size, require), world_size)


def make_mesh(axes=None, world_size=None):
    """``axes``: {name: size}; -1 absorbs the remaining ranks."""
    if world_size is None:
        world_size = dist.get_world_size() if distributed() else 1
    axes = dict(axes or {"data": -1})
    fixed = 1
    wild = None
    for name, size in axes.items():
        if size == -1:
            wild = name
        else:
            fixed *= size
    if wild is not None:
        axes[wild] = max(1, world_size // fixed)
    count = math.prod(axes.values())
    if count > world_size:
        raise ValueError("mesh %r needs %d devices, have %d"
                         % (axes, count, world_size))
    return Mesh(axes, world_size)


class Sharding(object):
    """A spec on a mesh (the counterpart of ``NamedSharding``)."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = tuple(spec)

    def __repr__(self):
        return "Sharding(%r, %r)" % (self.mesh, self.spec)


def replicated(mesh):
    return Sharding(mesh, ())


def shard_batch(mesh, axis="data", ndim=2):
    """Batch-dim sharding: the first dim split over ``axis``."""
    return Sharding(mesh, (axis,) + (None,) * (ndim - 1))


def shard_model(mesh, dim, ndim=2, axis="model"):
    """Tensor-parallel sharding of parameter dim ``dim``."""
    spec = [None] * ndim
    spec[dim] = axis
    return Sharding(mesh, spec)


def _axes_of(entry):
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def shard(tensor, spec, mesh):
    """This rank's slice (a view) of the global ``tensor`` (a tensor or
    a numpy array) under ``spec`` (a dim over several axes splits
    row-major over them).  Raises when a
    sharded dim does not divide over its axes."""
    spec = getattr(spec, "spec", spec)
    for dim, entry in enumerate(spec):
        axes = _axes_of(entry)
        parts = mesh.axis_size(*axes)
        if parts == 1:
            continue
        extent = tensor.shape[dim]
        if extent % parts:
            raise ValueError(
                "dim %d of size %d does not divide over axes %r (%d "
                "shards)" % (dim, extent, axes, parts))
        step = extent // parts
        start = mesh.index(*axes) * step
        cut = [slice(None)] * dim + [slice(start, start + step)]
        tensor = tensor[tuple(cut)]
    return tensor


def unshard(tensor, spec, mesh):
    """The global tensor from this rank's slice under ``spec``: an
    all-gather along each sharded dim over its axes' group."""
    spec = getattr(spec, "spec", spec)
    for dim, entry in enumerate(spec):
        axes = _axes_of(entry)
        if mesh.axis_size(*axes) == 1:
            continue
        tensor = all_gather(tensor, mesh.group(*axes), dim)
    return tensor

