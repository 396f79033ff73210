"""Data parallelism over the alignment's sequences with ``torch.distributed``
(the port of ``pydca_tpu/parallel``): one process per rank, each holding a
stripe of the rows; every sum over sequences is a collective.  The ranks
come from ``torchrun`` or, for a CLI run over every card of one process,
from :func:`~pydca_tpu_torch.parallel.spawn.spawn_cli`."""

from .mesh import (  # noqa: F401
    DataMesh,
    make_mesh,
    resolve_mesh,
    shard_msa,
)
from .data import (  # noqa: F401
    ShardedMSA,
    read_msa_distributed,
    weights_distributed,
)
from .fit import (  # noqa: F401
    fit_plm_sharded,
    init_distributed,
    mfdca_sharded,
    sequence_weights_sharded,
)
from .spawn import (  # noqa: F401
    spawn_cli,
    spawn_world,
)
