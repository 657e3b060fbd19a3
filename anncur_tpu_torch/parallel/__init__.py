"""Process-group meshes, multi-process helpers and tensor parallelism on
``torch.distributed`` (counterpart of ``anncur_tpu/parallel``)."""

from anncur_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    default_mesh,
    make_mesh,
    mesh_session,
    replicate,
    shard_batch,
)
