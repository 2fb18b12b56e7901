"""Node-sharded (model-axis) graph message passing, and the rank functions
that the multi-device checks run."""

from mmdfn_torch.parallel.graph_parallel import (sharded_gcnii_stack,
                                                 sharded_spmm,
                                                 sharded_spmm_batched)

__all__ = ["sharded_spmm", "sharded_spmm_batched", "sharded_gcnii_stack"]
