"""The one switch between the kernels and their plain versions."""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

plain = False


@contextlib.contextmanager
def plain_ops() -> Iterator[None]:
    """Within this block every wrapper runs its plain PyTorch version on
    any device and launches nothing; this is how the card holds the kernel
    path against the plain one."""
    global plain
    prev, plain = plain, True
    try:
        yield
    finally:
        plain = prev


def is_batched(t) -> bool:
    """Whether ``t`` is a tensor batched by ``torch.func.vmap`` (the
    grouped sweep's config axis): a wrapper that hides that axis, with no
    storage of its own and ``requires_grad`` False whatever its contents.
    The wrappers then route through an autograd Function whose ``vmap``
    rule makes one config-axis launch."""
    return (isinstance(t, torch.Tensor)
            and torch._C._functorch.is_batchedtensor(t))


def config_axis(info, in_dims, args, shared=()):
    """The operands of a ``vmap`` rule with the config axis in front:
    each batched one moved there, each unbatched one that is not in
    ``shared`` (indices) expanded to ``info.batch_size``; None stays None.
    A batched operand among ``shared`` raises: it is the same for every
    configuration."""
    K = info.batch_size
    out = []
    for i, (t, d) in enumerate(zip(args, in_dims)):
        if i in shared:
            if d is not None:
                raise ValueError("an operand shared across configurations "
                                 "is batched under vmap")
            out.append(t)
        elif not isinstance(t, torch.Tensor):
            out.append(t)
        elif d is None:
            out.append(t.expand(K, *t.shape))
        else:
            out.append(t.movedim(d, 0))
    return out


def vmap_plain(fn, args, shared=()):
    """A plain version ``fn`` over the leading config axis of ``args``, as
    one ``torch.func.vmap`` call: the operands at ``shared`` (indices) and
    the None ones are the same for every configuration."""
    in_dims = tuple(None if t is None or i in shared else 0
                    for i, t in enumerate(args))
    return torch.func.vmap(fn, in_dims=in_dims)(*args)
