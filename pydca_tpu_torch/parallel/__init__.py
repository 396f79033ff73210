"""Data parallelism over the alignment's sequences with ``torch.distributed``
(the port of ``pydca_tpu/parallel``): one process per rank, each holding a
stripe of the rows; every sum over sequences is a collective."""

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
