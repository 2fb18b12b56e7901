"""Node-axis (tensor) parallel graph message passing
(``mmdfn_tpu/parallel/graph_parallel.py``) over the mesh's ``model`` axis.

Data parallelism covers every production MM-DFN configuration, since the
adjacency is block-diagonal per dialogue (``runtime/mesh.py``).  This
module covers one graph too large for a card: the node axis shards over M
model ranks.  Rank r owns node rows ``rows_r`` (N/M of them) and the
matching column block ``adj[..., rows_r]`` of the adjacency; ``adj @ h``
is then the sum over ranks of the partial products
``adj[..., rows_r] @ h[rows_r]``, reduced with one reduce-scatter that
leaves each rank its own rows of the product.

The JAX package writes this with ``shard_map`` and lets XLA transpose the
collectives.  Here each collective is a ``torch.autograd.Function`` with
its transpose written out:

* reduce-scatter over the node axis; its backward is an all-gather;
* all-gather of the row blocks; its backward is the slice of this rank's
  rows (every model rank holds the same gradient of the gathered
  product, so a reduce-scatter would scale it by M);
* an identity whose backward sums over the model group: on each rank the
  partial product gives the gradient of ``adj``'s column block and of
  ``h``'s row block only, zero elsewhere, so the sum is the whole
  gradient.

Communication per GCNII layer: :func:`sharded_spmm_batched`, the hook the
models call (``GCNIIStack(spmm=...)``), returns the whole product and
costs one reduce-scatter and one all-gather of (B, N, H) a layer (and
their transposes in the backward); its gradients of ``adj`` and ``h`` come
out whole and equal on every model rank, so the parameters need no
reduction over the model group.  :func:`sharded_gcnii_stack` keeps the
rows sharded across its layers, as JAX's does: one reduce-scatter a
layer.  :func:`sharded_spmm` and :func:`sharded_gcnii_stack` take the
whole arrays (as JAX's take global arrays), need N divisible by M, and
return this rank's row block (JAX's ``P("model")`` output).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from mmdfn_torch.nn.gcn import gcnii_conv
from mmdfn_torch.runtime.mesh import MODEL_AXIS, all_gather, reduce_scatter

Tensor = torch.Tensor


class _SumGradOverGroup(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceScatter(torch.autograd.Function):
    """The group's sum of ``x``, this rank's block of dim ``dim``;
    backward: the all-gather of the blocks' gradients."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(x.movedim(dim, 0).contiguous(),
                              group).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        d = ctx.dim
        return (all_gather(g.movedim(d, 0).contiguous(), ctx.group)
                .movedim(0, d), None, None)


class _AllGather(torch.autograd.Function):
    """The group's blocks concatenated along dim ``dim``, the same on
    every rank; backward: this rank's block of the (equal) gradient."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        ctx.rank, ctx.n = dist.get_rank(group), dist.get_world_size(group)
        return all_gather(x.movedim(dim, 0).contiguous(),
                          group).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        blk = g.shape[ctx.dim] // ctx.n
        return g.narrow(ctx.dim, ctx.rank * blk, blk), None, None


def _rows(mesh, N: int):
    """This rank's slice of N node rows; N must split over the model axis."""
    M, r = mesh[MODEL_AXIS].size(), mesh.get_local_rank(MODEL_AXIS)
    if N % M:
        raise ValueError(f"{N} nodes do not split over the mesh model axis "
                         f"({M} ranks); sharded_spmm_batched pads them")
    blk = N // M
    return slice(r * blk, (r + 1) * blk)


def sharded_spmm(mesh, adj: Tensor, h: Tensor) -> Tensor:
    """``adj @ h`` with the node axis sharded over the ``model`` axis.

    adj: (N, N); h: (N, H), the same on every model rank.  Returns this
    rank's (N/M, H) row block of the product: the partial product
    ``adj[:, rows_r] @ h[rows_r]``, reduce-scattered over the rows."""
    rows = _rows(mesh, h.shape[0])
    partial = adj[:, rows] @ h[rows]
    return _ReduceScatter.apply(partial, mesh[MODEL_AXIS].get_group(), 0)


def sharded_spmm_batched(mesh, adj: Tensor, h: Tensor) -> Tensor:
    """Batched ``adj @ h`` with the node axis sharded over ``model``: the
    hook ``GCNIIStack(spmm=...)`` calls in place of ``adj @ h`` on a mesh
    with a model axis (the trainer sets it through
    ``build_model(cfg, gcn_spmm=...)``).

    adj: (B, N, N); h: (B, N, H), the same on every model rank.  Returns
    the whole (B, N, H) product on every model rank.  N is zero-padded to
    a multiple of M (zero rows and columns of the adjacency are inert), the
    partial products reduce-scatter over the nodes and the row blocks are
    gathered back; the gradients of ``adj`` and ``h`` are whole on every
    model rank."""
    M = mesh[MODEL_AXIS].size()
    if M == 1:
        return torch.bmm(adj, h)
    group = mesh[MODEL_AXIS].get_group()
    B, N, H = h.shape
    Np = -(-N // M) * M
    adj = _SumGradOverGroup.apply(adj, group)
    h = _SumGradOverGroup.apply(h, group)
    if Np != N:
        adj = torch.nn.functional.pad(adj, (0, Np - N, 0, Np - N))
        h = torch.nn.functional.pad(h, (0, 0, 0, Np - N))
    rows = _rows(mesh, Np)
    partial = torch.bmm(adj[:, :, rows], h[:, rows])
    out = _AllGather.apply(_ReduceScatter.apply(partial, group, 1), group, 1)
    return out[:, :N] if Np != N else out


def sharded_gcnii_stack(mesh, adj: Tensor, h: Tensor, h0: Tensor,
                        W: Tensor, theta: Tensor, alpha: float,
                        variant: bool = True) -> Tensor:
    """The deterministic deep GCNII stack with node-sharded message
    passing: per layer ``hi = adj @ h`` (one reduce-scatter), then the
    GCNII update and ReLU on this rank's rows alone.

    adj: (N, N); h, h0: (N, H); W: (nlayers, 2H, H) for the variant, else
    (nlayers, H, H); theta: (nlayers,); all the same on every model rank.
    Returns this rank's (N/M, H) row block of the last layer's output."""
    rows = _rows(mesh, h.shape[0])
    group = mesh[MODEL_AXIS].get_group()
    adj_cols, h_loc, h0_loc = adj[:, rows], h[rows], h0[rows]
    spmm = lambda a, x: _ReduceScatter.apply(a @ x, group, 0)
    for l in range(W.shape[0]):
        # the rows this rank owns: what its column block of adj multiplies
        # in the next layer's partial product
        h_loc = torch.relu(gcnii_conv(h_loc, adj_cols, h0_loc, W[l],
                                      theta[l], alpha, variant, spmm))
    return h_loc
