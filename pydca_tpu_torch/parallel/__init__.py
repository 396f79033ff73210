"""Parallelism with ``torch.distributed`` (the port of
``pydca_tpu/parallel``): one process per rank on a ('data', 'model') grid
(:func:`~pydca_tpu_torch.parallel.mesh.make_mesh`).  The data axis shards
the alignment's sequences, every sum over them a collective; the model
axis shards the rows of the mean-field correlation and coupling matrices
(:func:`~pydca_tpu_torch.parallel.fit.mfdca_sharded`).  The ranks come from
``torchrun`` or, for a CLI run over every card of one process, from
:func:`~pydca_tpu_torch.parallel.spawn.spawn_cli`."""

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
