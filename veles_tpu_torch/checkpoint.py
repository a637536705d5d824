"""Training-state checkpoints: the port's counterpart of
:mod:`veles_tpu.checkpoint`.

Where :mod:`veles_tpu_torch.snapshotter` pickles the whole workflow,
this module saves the training state itself: a tree of arrays (the
units' ``checkpoint_state()`` arrays from
``Workflow.capture_train_state``, or any params tree), the loader's
cursor and the random streams' positions.  The JAX package writes an
Orbax directory; Orbax is not on the card's machine, so the port has a
format of its own:

* a step is the directory ``<directory>/<step>/`` holding ``train.npz``
  (the tree's leaves as a ``numpy.savez`` archive with no pickled
  object, its nested keys flattened to ``/``-joined paths) and
  ``meta.json`` (the loader state, the streams' states and the rank
  count, through :func:`_jsonify`);
* a step is written into a temporary directory and committed with
  ``os.replace``, which is atomic as Orbax's commit is: a step that a
  crash left half-written is never taken for the latest one;
* ``max_to_keep`` keeps the newest steps and removes the others.

``restore(abstract, step)`` places each leaf as the matching leaf of
``abstract`` says, as Orbax restores onto the shardings it is given: a
torch tensor (its dtype and device), a numpy array (its dtype, on the
host), an :class:`ArraySpec` ``(shape, dtype, device[, sharding])`` or a
:class:`ShardedLeaf`.

Across ranks: a leaf of the saved tree may be a :class:`ShardedLeaf`
(this rank's slice and its
:class:`~veles_tpu_torch.parallel.mesh.Sharding`), which the save
gathers over the spec's groups; a workflow's ``capture_train_state``
gathers its sharded Vectors itself (``Vector.map_read``).  Every rank of
the default group calls ``save`` in the same order, rank 0 writes the
step and the others wait for its commit.  The step records the rank
count, and any rank count restores it: an abstract leaf with a sharding
gets this rank's slice of the whole array under the new mesh, so a
train state saved by N ranks restores on M (a pod re-shards the
restored Vectors by its own rules when they upload).
"""

import collections
import json
import os
import shutil

import numpy
import torch

from veles_tpu_torch import prng
from veles_tpu_torch.logger import Logger

#: an abstract leaf: the counterpart of ``jax.ShapeDtypeStruct``
#: (``dtype`` a numpy or torch dtype; ``device`` None restores numpy;
#: ``sharding`` a mesh Sharding restores this rank's slice)
ArraySpec = collections.namedtuple("ArraySpec", "shape dtype device sharding",
                                   defaults=(None,))

#: a leaf held as this rank's slice of a global array (``tensor``) under
#: ``sharding`` (a :class:`veles_tpu_torch.parallel.mesh.Sharding`):
#: saved whole, restored as the slice of the same placement
ShardedLeaf = collections.namedtuple("ShardedLeaf", "tensor sharding")

_TRAIN_FILE = "train.npz"
_META_FILE = "meta.json"
_TMP_PREFIX = ".tmp-"


def _world_size():
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _rank():
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _barrier():
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        dist.barrier()


def _flatten(tree, prefix=""):
    """``{path: leaf}`` of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        items = [(str(k), v) for k, v in tree.items()]
    elif isinstance(tree, (list, tuple)) and not isinstance(
            tree, (ArraySpec, ShardedLeaf)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {prefix: tree}
    out = {}
    for key, value in items:
        if "/" in key:
            raise ValueError("checkpoint key %r holds a '/'" % key)
        out.update(_flatten(value, "%s/%s" % (prefix, key) if prefix
                            else key))
    return out


def _unflatten(abstract, leaves, prefix=""):
    """``abstract``'s structure with each leaf made by ``leaves(path,
    leaf)``."""
    if isinstance(abstract, dict):
        return {k: _unflatten(v, leaves, "%s/%s" % (prefix, k) if prefix
                              else str(k))
                for k, v in abstract.items()}
    if isinstance(abstract, (list, tuple)) and not isinstance(
            abstract, (ArraySpec, ShardedLeaf)):
        seq = [_unflatten(v, leaves, "%s/%d" % (prefix, i) if prefix
                          else str(i))
               for i, v in enumerate(abstract)]
        return type(abstract)(seq) if isinstance(abstract, tuple) else seq
    return leaves(prefix, abstract)


def _host_array(leaf):
    if isinstance(leaf, ShardedLeaf):
        from veles_tpu_torch.parallel.mesh import unshard
        leaf = unshard(leaf.tensor.detach(), leaf.sharding.spec,
                       leaf.sharding.mesh)
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return numpy.asarray(leaf)


def _torch_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(numpy.empty(0, numpy.dtype(dtype))).dtype


def _place(array, like):
    """``array`` as the abstract leaf ``like`` places it (a sharded
    one: this rank's slice of it)."""
    sharding = None
    if isinstance(like, ShardedLeaf):
        sharding, tensor = like.sharding, like.tensor
        if tuple(array.shape) != tuple(_global_shape(tensor, sharding)):
            raise ValueError("checkpoint leaf of shape %s, the abstract "
                             "leaf's is %s" % (array.shape, tuple(
                                 _global_shape(tensor, sharding))))
        return ShardedLeaf(_place(array, ArraySpec(
            array.shape, tensor.dtype, tensor.device, sharding)), sharding)
    if isinstance(like, torch.Tensor):
        shape, dtype, device = tuple(like.shape), like.dtype, like.device
    elif isinstance(like, ArraySpec):
        shape, dtype, device = tuple(like.shape), like.dtype, like.device
        sharding = like.sharding
    else:
        like = numpy.asarray(like)
        shape, dtype, device = like.shape, like.dtype, None
    if tuple(array.shape) != tuple(shape):
        raise ValueError("checkpoint leaf of shape %s, the abstract "
                         "leaf's is %s" % (array.shape, tuple(shape)))
    if sharding is not None:
        from veles_tpu_torch.parallel.mesh import shard
        array = numpy.ascontiguousarray(shard(array, sharding.spec,
                                              sharding.mesh))
    if device is None:
        if isinstance(dtype, torch.dtype):
            return torch.from_numpy(array).to(dtype).numpy()
        return array.astype(dtype, copy=False)
    return torch.from_numpy(array).to(device=device,
                                      dtype=_torch_dtype(dtype))


def _global_shape(tensor, sharding):
    """The whole array's shape of a slice under ``sharding``."""
    from veles_tpu_torch.parallel.mesh import _axes_of
    shape = list(tensor.shape)
    for dim, entry in enumerate(sharding.spec):
        shape[dim] *= sharding.mesh.axis_size(*_axes_of(entry))
    return tuple(shape)


class TrainCheckpointer(Logger):
    """Save and restore ``(step, train_state, loader_state)`` with the
    random streams' states riding in the meta."""

    def __init__(self, directory, max_to_keep=3):
        super(TrainCheckpointer, self).__init__()
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    # -- the random streams ---------------------------------------------------
    @staticmethod
    def _prng_states():
        return {name: gen.__getstate__()
                for name, gen in prng._streams.items()}

    @staticmethod
    def _restore_prng(states):
        for name, state in (states or {}).items():
            prng.get(name).__setstate__(state)

    # -- the steps --------------------------------------------------------------
    def _step_dir(self, step):
        return os.path.join(self.directory, str(int(step)))

    def all_steps(self):
        """The committed steps, oldest first."""
        steps = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.isfile(os.path.join(
                    self.directory, name, _META_FILE)):
                steps.append(int(name))
        return sorted(steps)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- the api ------------------------------------------------------------------
    def save(self, step, train_state, loader_state=None):
        """Write and commit the checkpoint of ``step`` (every rank calls
        it: the sharded leaves are gathered, rank 0 writes, the others
        wait for its commit)."""
        final = self._step_dir(step)
        if os.path.exists(final):
            raise FileExistsError("step %d is already checkpointed in %s"
                                  % (step, self.directory))
        # every rank has looked before rank 0 may commit: a rank that
        # came late would find the step written and raise alone
        _barrier()
        arrays = {}
        for path, leaf in _flatten(train_state).items():
            array = _host_array(leaf)
            if array.dtype.hasobject:
                raise TypeError("checkpoint leaf %r holds Python objects"
                                % path)
            arrays[path] = array
        meta = {"loader": loader_state or {},
                "prng": self._prng_states(),
                "world_size": _world_size()}
        if _rank() != 0:
            _barrier()
            return
        try:
            self._commit(step, final, arrays, meta)
        finally:
            _barrier()

    def _commit(self, step, final, arrays, meta):
        tmp = os.path.join(self.directory,
                           "%s%d-%d" % (_TMP_PREFIX, step, os.getpid()))
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        try:
            with open(os.path.join(tmp, _TRAIN_FILE), "wb") as fout:
                numpy.savez(fout, **arrays)
            with open(os.path.join(tmp, _META_FILE), "w") as fout:
                json.dump(_jsonify(meta), fout)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        if self.max_to_keep:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)
        self.info("checkpointed step %d to %s", step, self.directory)

    def restore(self, abstract_train_state, step=None):
        """``(step, train_state, loader_state)`` of ``step`` (the latest
        when None), the tree placed as ``abstract_train_state``'s leaves
        say; the random streams continue from the saved positions."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoints in %s"
                                    % self.directory)
        folder = self._step_dir(step)
        if not os.path.isfile(os.path.join(folder, _META_FILE)):
            raise FileNotFoundError("no checkpoint of step %d in %s"
                                    % (step, self.directory))
        with open(os.path.join(folder, _META_FILE)) as fin:
            meta = _dejsonify(json.load(fin))
        with numpy.load(os.path.join(folder, _TRAIN_FILE),
                        allow_pickle=False) as archive:
            saved = {name: archive[name] for name in archive.files}

        def leaf(path, like):
            if path not in saved:
                raise KeyError("step %d has no leaf %r" % (step, path))
            return _place(saved[path], like)

        train = _unflatten(abstract_train_state, leaf)
        self._restore_prng(meta.get("prng"))
        self.info("restored step %d (saved by %d rank(s)) from %s on %d "
                  "rank(s)", step, int(meta.get("world_size", 1)),
                  self.directory, _world_size())
        return step, train, meta.get("loader", {})

    def close(self):
        """Nothing to release: every save is committed when it
        returns."""


def _jsonify(obj):
    """The PRNG and loader states hold tuples and ndarrays: a JSON
    round trip keeps them.  A dict with keys other than strings becomes
    a list of items, so the keys come back typed."""
    if isinstance(obj, dict):
        if all(isinstance(k, str) for k in obj):
            return {str(k): _jsonify(v) for k, v in obj.items()}
        return {"__items__": [[_jsonify(k), _jsonify(v)]
                              for k, v in obj.items()]}
    if isinstance(obj, (list, tuple)):
        return {"__seq__": [_jsonify(v) for v in obj],
                "__tuple__": isinstance(obj, tuple)}
    if isinstance(obj, numpy.ndarray):
        return {"__ndarray__": obj.tolist(), "__dtype__": str(obj.dtype)}
    if isinstance(obj, (numpy.integer,)):
        return int(obj)
    if isinstance(obj, (numpy.floating,)):
        return float(obj)
    if isinstance(obj, bytes):
        import base64
        return {"__bytes__": base64.b64encode(obj).decode()}
    return obj


def _dejsonify(obj):
    if isinstance(obj, dict):
        if "__seq__" in obj:
            seq = [_dejsonify(v) for v in obj["__seq__"]]
            return tuple(seq) if obj.get("__tuple__") else seq
        if "__ndarray__" in obj:
            return numpy.array(obj["__ndarray__"],
                               dtype=obj["__dtype__"])
        if "__bytes__" in obj:
            import base64
            return base64.b64decode(obj["__bytes__"])
        if "__items__" in obj:
            return {_hashable(_dejsonify(k)): _dejsonify(v)
                    for k, v in obj["__items__"]}
        return {k: _dejsonify(v) for k, v in obj.items()}
    return obj


def _hashable(key):
    """Dict keys back from JSON: a tuple key came back as a list (or an
    ndarray); make it hashable again."""
    if isinstance(key, numpy.ndarray):
        return tuple(key.tolist())
    if isinstance(key, list):
        return tuple(_hashable(k) for k in key)
    return key
