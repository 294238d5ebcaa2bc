"""Data and tensor parallelism for the port: one process per device
(`distributed`), the mesh record, row ownership, the shard plan and the
collectives (`mesh`), and the channel-sharded layers' state and
collectives (`tensor`)."""

from leaffliction_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    MeshSpec,
    check_replicated,
    local_rows,
    make_mesh,
)
