from .distributed import (all_reduce_sum, entry_device, init_distributed,  # noqa: F401
                          is_rank0, launch, rank_device, run_ranks)
from .sharding import Shard, check_replicated, replicate  # noqa: F401
