"""The SPMD library on ``torch.distributed`` and the elastic job layer.
Counterpart of :mod:`veles_tpu.parallel`.  The job layer
(:mod:`.jobs`, master–slave task distribution over the standard
library's TCP in :mod:`.wire`) is imported on its own: it needs no
process group.

Every process is one rank of the default process group
(:func:`multihost.initialize`: NCCL on the card, gloo on the CPU) and
runs the same program on its shards.  A :class:`~.mesh.Mesh` names axes
over the ranks (``data``, ``seq``, ``model``, ``pipe``, ``expert``) and
gives each axis's process group; the modules issue their collectives
through the counted wrappers of :mod:`.comm`:

* data parallelism (:mod:`.dp`): each rank's rows of the global
  minibatch through a step that averages the gradients over ``data``;
* tensor parallelism (:mod:`.tp`): Megatron's copy / reduce pair;
* sequence parallelism (:mod:`.ring`): ring-flash attention over the
  flash kernels at global causal offsets, and Ulysses;
* pipeline parallelism (:mod:`.pp`): a GPipe schedule of ring shifts;
* expert parallelism (:mod:`.moe`): the switch MLP's all-to-alls.
"""

from veles_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, MeshTopologyError, Sharding, make_mesh, mesh_from_topology,
    replicated, shard, shard_batch, unshard)
from veles_tpu_torch.parallel.dp import data_parallel  # noqa: F401
from veles_tpu_torch.parallel.ring import (  # noqa: F401
    mha_reference, ring_attention, ulysses_attention)
from veles_tpu_torch.parallel.pp import pipeline_apply  # noqa: F401
from veles_tpu_torch.parallel.tp import (  # noqa: F401
    column_parallel, constrain, row_parallel, shard_dim, sharding_tree)
from veles_tpu_torch.parallel.moe import moe_mlp  # noqa: F401
from veles_tpu_torch.parallel import multihost  # noqa: F401
