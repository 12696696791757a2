from .mesh import (ProcessMesh, allreduce_grads, gather_rows, get_mesh, process_mesh,
                   shard_batch)
from .multihost import (auto_initialize, host_shard, initialize_multihost, process_count,
                        process_index)
