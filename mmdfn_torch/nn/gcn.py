"""The deep GCNII stack (``mmdfn_tpu/nn/gcn.py`` ``GCNIIStack``) in its
three reference wirings, and the plain two-layer GCN of the GCN3 baseline.

``fc_in`` and ReLU give ``h = h0``; then per layer l = 1..nlayers, with
``theta_l = log(lamda / l + 1)``: the shared reason-LSTM step (gates
i, f, g, o; bias ``b_ih + b_hh``; state carried across layers), the GCNII
update (:func:`gcnii_conv`: the variant's by default, the original's with
``variant=False``), ReLU, dropout and the additive skip ``+q``.  In training
the input x is dropped before ``fc_in`` and h after its ReLU, with h0 kept
undropped (``mmdfn_tpu/nn/gcn.py:159-165``), and each layer's dropout bits
come from Philox under a seed drawn from the step's generator.  The layer
loop is :func:`mmdfn_torch.ops.gcnii_stack_fwd`: kernel B, and under
autograd kernel B's training mode with kernel D for the backward.  Every
wiring runs the same kernels; only the dropouts around them differ.

``backend='pallas'`` (or ``'pallas_fused'``; ``gcn_backend`` of the config)
runs the stack in the TPU training kernel's bf16 numerics (kernels B and
D's bf16 mode) wherever JAX's ``GCNIIStack`` takes that kernel
(``mmdfn_tpu/nn/gcn.py:187-192``): the variant's update, dropout after
each layer, no post-loop dropout, no node-sharded product, at most 64
layers.  Elsewhere JAX runs its layer scan, in bf16 where
``compute_dtype='bfloat16'`` (``:229-287``): kernels B and D's bf16 scan
mode, on every wiring (GF2's, DeepGCN's, ``variant=False``, the post-loop
dropout, more than 64 layers; with ``spmm`` its plain version), and for
every family where ``gcn_compute_dtype='bfloat16'`` comes without a
Pallas backend.  JAX's fallback off the TPU (live dropout takes the scan
there, the interpreter's PRNG being a stub) is not copied: on the CPU the
port runs the plain version of what the card runs.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from mmdfn_torch.graph.adjacency import directed_speaker_adjacency
from mmdfn_torch.nn import drop_override
from mmdfn_torch.nn.dropout import dropout
from mmdfn_torch.nn.init import reset_linear, reset_linears, reset_uniform
from mmdfn_torch.nn.linear import Linear
from mmdfn_torch.ops import (fold_weights, gcnii_stack_fwd, gcnii_stack_plain,
                             is_batched)
from mmdfn_torch.ops.gcnii import BF16, F32, SCAN

Tensor = torch.Tensor


def gcnii_conv(h: Tensor, adj: Tensor, h0: Tensor, W: Tensor,
               theta: Tensor, alpha: float, variant: bool,
               spmm: Optional[Callable[[Tensor, Tensor], Tensor]] = None
               ) -> Tensor:
    """One GCNII graph convolution (``mmdfn_tpu/nn/gcn.py:gcnii_conv``,
    reference ``model_GCN.py:176-189``): ``hi = adj @ h`` (or
    ``spmm(adj, h)``); the variant's ``support = [hi | h0]``, else
    ``support = r``; with ``r = (1-α) hi + α h0`` the output is
    ``θ (support @ W) + (1-θ) r``, before the ReLU."""
    hi = adj @ h if spmm is None else spmm(adj, h)
    r = (1.0 - alpha) * hi + alpha * h0
    support = torch.cat([hi, h0], dim=-1) if variant else r
    return theta * (support @ W) + (1.0 - theta) * r


class GraphConvolution(nn.Module):
    """One GCNII layer's weight, (2H, H) for the variant and (H, H)
    without, applied as ``support @ weight`` (reference
    ``model_GCN.py:160-189``)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_features, out_features))


class ReasonLSTM(nn.Module):
    """The shared one-layer LSTM's weights under ``nn.LSTM``'s names."""

    def __init__(self, hidden: int):
        super().__init__()
        H = hidden
        self.weight_ih_l0 = nn.Parameter(torch.empty(4 * H, H))
        self.weight_hh_l0 = nn.Parameter(torch.empty(4 * H, H))
        self.bias_ih_l0 = nn.Parameter(torch.empty(4 * H))
        self.bias_hh_l0 = nn.Parameter(torch.empty(4 * H))


# the backends of the JAX package's fused GCNII training kernel, and the
# most layers it takes (mmdfn_tpu/nn/gcn.py:187-189)
FUSED_BACKENDS = ("pallas", "pallas_fused")
FUSED_MAX_LAYERS = 64


def stack_mode(backend: Optional[str], compute_dtype: Optional[str], *,
               variant: bool, dropout_mode: str, post_loop_dropout: bool,
               nlayers: int, spmm) -> str:
    """The numerics a stack runs in (``ops.gcnii``'s modes): the bf16 mode
    where JAX's ``GCNIIStack`` takes its fused training kernel
    (``mmdfn_tpu/nn/gcn.py:187-192``, without the CPU-only fallback), else
    the bf16 scan mode where ``compute_dtype`` is ``'bfloat16'``
    (``:229-238``), else f32."""
    fused = (backend in FUSED_BACKENDS and variant and dropout_mode == "after"
             and spmm is None and not post_loop_dropout
             and nlayers <= FUSED_MAX_LAYERS)
    if fused:
        return BF16
    return SCAN if compute_dtype == "bfloat16" else F32


class GCNIIStack(nn.Module):
    """Deep GCNII stack; returns ``(x, h)`` (the input, for the residue
    concat, and the final hidden state).

    The wirings of the JAX ``GCNIIStack`` (``mmdfn_tpu/nn/gcn.py:61-80``):

    * ``GCNII_lyc`` (MM-DFN's, the default): ``has_fc_in=True``,
      ``dropout_mode='after'``, ``post_loop_dropout=False``;
    * ``GCNII`` (the DeepGCN baseline): ``dropout_mode='none'``,
      ``post_loop_dropout=True``: the kernels run at rate 0 and the
      output is dropped after them;
    * ``MM_GCN2``'s loop (GF2): ``has_fc_in=False``,
      ``dropout_mode='before'``, ``post_loop_dropout=True``: h = h0 = x.

    ``variant=False`` builds each layer's weight (H, H), the original GCNII
    update; kernels B and D then run on its fold (``ops.fold_weights``).

    ``backend`` and ``compute_dtype``: the config's ``gcn_backend`` and
    ``gcn_compute_dtype``; ``self.mode`` is the numerics the stack runs in
    (:func:`stack_mode`).

    ``spmm`` replaces each layer's ``adj @ h`` (the node-sharded product
    of a mesh with a model axis, ``parallel/graph_parallel.py``).  With it
    the stack runs its plain version on any device and launches neither
    kernel B nor D, as the JAX stack leaves its fused kernel for the scan
    when ``spmm`` is set (``mmdfn_tpu/nn/gcn.py:188``); the dropout is the
    same Philox mask.  ``relu_inputs``, None unless a caller sets it to a
    list, then receives each layer's ReLU input on that path, detached, so
    that a check can hold a step at another's ReLU decisions.
    """

    def __init__(self, nfeat: int, nlayers: int, nhidden: int,
                 lamda: float = 0.5, alpha: float = 0.2,
                 reason_flag: bool = False, dropout: float = 0.0,
                 has_fc_in: bool = True, dropout_mode: str = "after",
                 post_loop_dropout: bool = False,
                 spmm: Optional[Callable[[Tensor, Tensor], Tensor]] = None,
                 rate_tag: Optional[str] = None, variant: bool = True,
                 backend: Optional[str] = None,
                 compute_dtype: Optional[str] = None):
        super().__init__()
        if dropout_mode not in ("after", "before", "none"):
            raise ValueError(f"dropout_mode {dropout_mode!r}")
        if dropout_mode == "before" and (reason_flag
                                         or not post_loop_dropout):
            # the kernels draw after each layer; see forward
            raise ValueError("dropout_mode='before' runs with the post-loop "
                             "dropout and without the reason-LSTM only")
        self.nhidden = nhidden
        self.alpha = alpha
        self.variant = variant
        self.dropout = dropout
        self.reason_flag = reason_flag
        self.has_fc_in = has_fc_in
        self.dropout_mode = dropout_mode
        self.post_loop_dropout = post_loop_dropout
        self.spmm = spmm
        self.rate_tag = rate_tag
        self.relu_inputs: Optional[list] = None
        self._cache = None       # (parameter key, packed weights)
        self.mode = stack_mode(backend, compute_dtype, variant=variant,
                               dropout_mode=dropout_mode,
                               post_loop_dropout=post_loop_dropout,
                               nlayers=nlayers, spmm=spmm)
        if has_fc_in:
            self.fcs = nn.ModuleList([Linear(nfeat, nhidden)])
        self.convs = nn.ModuleList(
            [GraphConvolution((2 if variant else 1) * nhidden, nhidden)
             for _ in range(nlayers)])
        self.rnn = ReasonLSTM(nhidden) if reason_flag else None
        self.register_buffer(
            "theta", torch.log(lamda / torch.arange(1, nlayers + 1,
                                                    dtype=torch.float32) + 1.0),
            persistent=False)
        # a subclass's own layers are initialised by their constructors
        GCNIIStack.reset_parameters(self)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """torch defaults: Linear U(-1/sqrt(in), .); the GCNII conv
        U(-1/sqrt(H), .) (``model_GCN.py:172-174``); LSTM U(-1/sqrt(H), .)."""
        k = 1.0 / math.sqrt(self.nhidden)
        if self.has_fc_in:
            reset_linear(self.fcs[0], generator)
        reset_uniform([c.weight for c in self.convs], k, generator)
        if self.rnn is not None:
            reset_uniform(self.rnn.parameters(), k, generator)

    def _packed(self) -> tuple:
        """The layer weights as kernel B takes them: W stacked to
        (nlayers, 2H, H) (or (nlayers, H, H)), its fold without the
        variant outside the bf16 scan mode (else None), the LSTM weights
        contiguous as (H, 4H) and ``b_ih + b_hh`` (the bf16 scan mode:
        ``[b_ih; b_hh]``).  With autograd off (serving) they are built once
        and rebuilt only after a parameter moves or is written in place;
        with autograd on they are built afresh so gradients reach them
        (the fold is then left to ``gcnii_stack_fwd``, inside the graph)."""
        params = [c.weight for c in self.convs]
        if self.rnn is not None:
            params += list(self.rnn.parameters())
        # under torch.func.vmap (the grouped sweep) the parameters are
        # batched wrappers, with no storage of their own to key on
        keep = not (torch.is_grad_enabled() or is_batched(params[0]))
        key = (tuple((p.data_ptr(), p._version) for p in params)
               if keep else None)
        if keep and self._cache is not None and self._cache[0] == key:
            return self._cache[1]
        W = torch.stack([conv.weight for conv in self.convs])
        folded = (fold_weights(W, self.alpha)
                  if keep and not self.variant and self.mode != SCAN
                  else None)
        if self.reason_flag:
            r = self.rnn
            b = (torch.stack([r.bias_ih_l0, r.bias_hh_l0])
                 if self.mode == SCAN else r.bias_ih_l0 + r.bias_hh_l0)
            packed = (W, folded, r.weight_ih_l0.t().contiguous(),
                      r.weight_hh_l0.t().contiguous(), b)
        else:
            packed = (W, folded, None, None, None)
        self._cache = (key, packed) if keep else None
        return packed

    def forward(self, x: Tensor, adj: Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[Tensor, Tensor]:
        """Returns (x, h): the input as the residue concat takes it
        (dropped in training, as the reference reuses its mutated ``x``)
        and the final hidden state."""
        W, folded, *lstm = self._packed()
        rate = self.dropout if train else 0.0
        tag = self.rate_tag
        # under an override (the grouped sweep) the stack always draws, as
        # JAX's does (mmdfn_tpu/nn/gcn.py:151); kernels B and D then take
        # each configuration's threshold and keep scale
        ov = drop_override.get(tag) if generator is not None else None
        if self.has_fc_in:
            x = dropout(x, rate, generator, tag)
            h0 = torch.relu(self.fcs[0](x))
            h = dropout(h0, rate, generator, tag)
        else:
            h0 = h = x
        scan = self.mode == SCAN
        if self.dropout_mode == "before":
            # "drop before each layer, then after the loop" draws as "drop
            # the entry, then after each layer": layer l's after-drop is
            # layer l+1's before-drop and the last layer's is the post-loop
            # drop.  So the kernels run in their after-mode on h = drop(x)
            # beside h0 = x, and the entry's gradient reaches x through
            # both.  In the bf16 scan mode the entry's drop is the first
            # in-loop one, in bf16, and the last layer's the post-loop
            # one, in f32 (mmdfn_tpu/nn/gcn.py:256-257,282-285).
            h = dropout(h, rate, generator, tag, bf16=scan)
        if self.dropout_mode == "none":
            in_loop = 0.0
        else:
            in_loop = rate if ov is None else ov
        last_f32 = scan and self.dropout_mode == "before"
        seed = None
        if ov is not None and in_loop is ov or in_loop > 0.0:
            # the kernels' Philox key, never read by the host
            seed = torch.randint(0, 1 << 62, (1,), generator=generator,
                                 device=x.device)
        if self.spmm is None:
            h = gcnii_stack_fwd(adj, h, h0, W, self.theta, *lstm,
                                alpha=self.alpha, reason=self.reason_flag,
                                rate=in_loop, seed=seed, variant=self.variant,
                                folded=folded, mode=self.mode,
                                last_drop_f32=last_f32)
        else:
            h = gcnii_stack_plain(adj, h, h0, W, self.theta, *lstm,
                                  alpha=self.alpha, reason=self.reason_flag,
                                  rate=in_loop, seed=seed, spmm=self.spmm,
                                  relu_inputs=self.relu_inputs,
                                  variant=self.variant, mode=self.mode,
                                  last_drop_f32=last_f32)
        if self.post_loop_dropout and self.dropout_mode != "before":
            h = dropout(h, rate, generator, tag)
        return x, h


class GCNLayer1(nn.Module):
    """Plain GCN layer over the directed speaker chain (reference
    ``model_GCN.py:8-23`` with its default ``new_graph=True``): the chain
    built from the inputs, unnormalized, then ``linear(adj @ x)``."""

    def __init__(self, in_feats: int, out_feats: int):
        super().__init__()
        self.linear = Linear(in_feats, out_feats)

    def forward(self, x: Tensor, qmask: Tensor, umask: Tensor) -> Tensor:
        adj = directed_speaker_adjacency(x, qmask, umask)
        return self.linear(adj @ x)


class GCN2Layers(nn.Module):
    """Two GCNLayer1 and the residue concat (reference ``GCN_2Layers``,
    ``model_GCN.py:121-154``): the features, or with ``return_feature``
    off (the single-stream head) the classifier ``linear`` and
    log-softmax.  Without the residue the reference returns the second
    layer's log-probs over the classes, which the port keeps."""

    def __init__(self, in_feats: int, hidden: int, n_classes: int,
                 use_residue: bool = True, return_feature: bool = True):
        super().__init__()
        self.use_residue = use_residue
        self.gcn1 = GCNLayer1(in_feats, hidden)
        self.gcn2 = GCNLayer1(hidden, hidden if use_residue else n_classes)
        if use_residue and not return_feature:
            self.linear = Linear(in_feats + hidden, n_classes)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_linears(self, generator)

    def forward(self, x: Tensor, qmask: Tensor, umask: Tensor) -> Tensor:
        g = self.gcn2(self.gcn1(x, qmask, umask), qmask, umask)
        if not self.use_residue:
            return torch.log_softmax(g, dim=-1)
        feat = torch.cat([x, g], dim=-1)
        if hasattr(self, "linear"):
            return torch.log_softmax(self.linear(feat), dim=-1)
        return feat
