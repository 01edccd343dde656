from .rules import (PartitionSpec, cache_shardings,  # noqa: F401
                    data_shardings, param_shardings, placements,
                    state_shardings)
