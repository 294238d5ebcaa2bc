"""Data parallelism for the port: one process per device (`distributed`),
the mesh record, row ownership and the collectives (`mesh`)."""

from leaffliction_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    MeshSpec,
    check_replicated,
    local_rows,
    make_mesh,
)
