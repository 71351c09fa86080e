"""Sample- and field-parallel execution over ``torch.distributed``
(counterpart of ``nifty_tpu.parallel``): the process group and meshes
(:mod:`.multihost`, :mod:`.mesh`), the pencil FFT and Hartley of a
row-sharded field (:mod:`.fft`) and the collectives of sharded execution
(:mod:`.collectives`)."""

from .collectives import field_sharded, reduce_sum, replicate
from .fft import sharded_fft2, sharded_fftn, sharded_hartley, sharded_hartley2
from .mesh import NamedSharding, replicated_sharding, sample_mesh, sample_sharding
from .multihost import (
    global_mesh,
    host_local_slice,
    initialize,
    process_count,
    process_index,
)

__all__ = [
    "NamedSharding",
    "field_sharded",
    "global_mesh",
    "host_local_slice",
    "initialize",
    "process_count",
    "process_index",
    "reduce_sum",
    "replicate",
    "replicated_sharding",
    "sample_mesh",
    "sample_sharding",
    "sharded_fft2",
    "sharded_fftn",
    "sharded_hartley",
    "sharded_hartley2",
]
