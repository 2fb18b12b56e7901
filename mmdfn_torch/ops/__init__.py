"""Hand-written CUDA kernels of the port, each beside its plain version.

Every wrapper launches its kernel for CUDA tensors (or raises), runs the
plain PyTorch version for CPU tensors or inside :func:`plain_ops`, and
counts its kernel launches in ``<wrapper>.launches``.
"""

from mmdfn_torch.ops._mode import plain_ops
from mmdfn_torch.ops.bigru import (bigru_layer_bwd, bigru_layer_bwd_plain,
                                   bigru_layer_fwd, bigru_layer_plain)
from mmdfn_torch.ops.gcnii import (gcnii_stack_bwd, gcnii_stack_bwd_plain,
                                   gcnii_stack_fwd, gcnii_stack_plain)

WRAPPERS = {"bigru_fwd": bigru_layer_fwd, "bigru_bwd": bigru_layer_bwd,
            "gcnii_fwd": gcnii_stack_fwd, "gcnii_bwd": gcnii_stack_bwd}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
