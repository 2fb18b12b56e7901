"""The port's CUDA kernels against their plain versions on the card.

These tests import no JAX, so the card's machine can run them:
``python -m pytest --noconftest -q tests/test_torch_gpu.py``.  Without a
card each test skips itself.
"""

import pytest
import torch

from mmdfn_torch.graph.adjacency import mm_big_adjacency
from mmdfn_torch.ops import (bigru_layer_bwd, bigru_layer_bwd_plain,
                             bigru_layer_fwd, bigru_layer_plain, fold_weights,
                             gcnii_stack_bwd, gcnii_stack_bwd_plain,
                             gcnii_stack_fwd, gcnii_stack_plain, philox,
                             plain_ops)
from mmdfn_torch.ops.bigru import _forward as bigru_forward, _sm_count
from mmdfn_torch.ops.gcnii import (DESIGNS, RESIDUALS, RESIDUALS_BF16,
                                   _design, _lstm_step, gcnii_bwd_launches,
                                   gcnii_fwd_launches,
                                   _forward as gcnii_forward)

H = 100


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bigru_args(dev, B, L, seed):
    g = torch.Generator().manual_seed(seed)
    u = lambda *s: (torch.rand(*s, generator=g) * 0.2 - 0.1).to(dev)
    xg_f = torch.randn(B, L, 3 * H, generator=g).to(dev)
    xg_b = torch.randn(B, L, 3 * H, generator=g).to(dev)
    mask = (torch.rand(B, L, generator=g) > 0.3).float().to(dev)  # holes
    w_f, w_b = u(3 * H, H), u(3 * H, H)
    return (xg_f, xg_b, w_f.t(), u(3 * H), w_b.t(), u(3 * H), mask), g


# every rows-per-block variant of kernels A and C on an H100 (B = 1..66:
# 1 row, 67: 2, 133 and 192: 4, 300: 4 in more than one wave), ragged
# tails, L = 1, and the training shapes: IEMOCAP's, and MELD's party
# streams (32 dialogues x 9 speakers x 3 modalities = 864 rows, 4 a block,
# 432 blocks in more than three waves)
BIGRU_SHAPES = [(1, 200), (6, 64), (13, 9), (32, 80), (67, 1), (133, 7),
                (192, 80), (300, 5), (864, 33)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,L", BIGRU_SHAPES)
def test_bigru_kernel_matches_plain(B, L):
    dev = _card()
    args, _ = _bigru_args(dev, B, L, B * 1000 + L)
    got = bigru_layer_fwd(*args)
    torch.cuda.synchronize()
    want = bigru_layer_plain(*args)
    for a, b in zip(got, want):
        # f32 on both sides; only the summation order of h @ W_hh differs
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("B,L", BIGRU_SHAPES)
def test_bigru_bwd_kernel_matches_plain(B, L):
    """Kernel C on the ys and hg that kernel A's training mode wrote, at
    the training shapes (lstm_l B = 32, the party streams B = 192, both
    L = 80, holed masks) and the other variants."""
    dev = _card()
    args, g = _bigru_args(dev, B, L, B * 7 + L)
    ys_hg = bigru_forward(*args, with_hg=True)
    dy = [torch.randn(B, L, H, generator=g).to(dev) for _ in range(2)]
    got = bigru_layer_bwd(*args, *ys_hg[:2], *dy, *ys_hg[2:])
    torch.cuda.synchronize()
    want = bigru_layer_bwd_plain(*args, *ys_hg[:2], *dy)
    for a, b in zip(got, want):
        # f32; dW_hh sums B L terms in another order: relative to its scale
        scale = float(b.abs().max().clamp(min=1.0))
        torch.testing.assert_close(a, b, atol=1e-5 * scale, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("B,L", [(6, 64), (192, 80)])
def test_bigru_training_mode_writes_the_plain_hg(B, L):
    """Kernel A's training mode: ys bit-equal to the serve launch, hg equal
    to the plain forward's."""
    dev = _card()
    args, _ = _bigru_args(dev, B, L, B + 5 * L)
    serve = bigru_forward(*args)
    got = bigru_forward(*args, with_hg=True)
    torch.cuda.synchronize()
    assert torch.equal(serve[0], got[0]) and torch.equal(serve[1], got[1])
    want = bigru_layer_plain(*args, with_hg=True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


@pytest.mark.gpu
def test_bigru_kernels_keep_masked_frames_out():
    """An all-masked row and a NaN in a masked frame: every output and
    gradient finite, and the clean rows as without the poison."""
    dev = _card()
    B, L = 13, 20
    args, g = _bigru_args(dev, B, L, 99)
    xg_f, xg_b, w_f, b_f, w_b, b_b, mask = args
    mask = mask.clone()
    mask[3] = 0.0                        # a row with no valid frame
    mask[5, 7] = 0.0
    xg_f, xg_b = xg_f.clone(), xg_b.clone()
    xg_f[5, 7] = float("nan")
    xg_b[5, 7] = float("inf")
    xg_f[3] = float("nan")
    args = (xg_f, xg_b, w_f, b_f, w_b, b_b, mask)
    ys_hg = bigru_forward(*args, with_hg=True)
    dy = [torch.randn(B, L, H, generator=g).to(dev) for _ in range(2)]
    grads = bigru_layer_bwd(*args, *ys_hg[:2], *dy, *ys_hg[2:])
    torch.cuda.synchronize()
    for t in (*ys_hg, *grads):
        assert bool(torch.isfinite(t).all())
    assert not bool(ys_hg[0][3].any()) and not bool(ys_hg[1][3].any())
    assert not bool(grads[0][3].any()) and not bool(grads[0][5, 7].any())


@pytest.mark.gpu
def test_bigru_kernels_refuse_a_width_they_do_not_take():
    """The kernels hold W_hh in registers for H = 100 only: another width
    raises before any launch."""
    dev = _card()
    B, L, width = 2, 3, 64
    xg = torch.zeros(B, L, 3 * width, device=dev)
    w = torch.zeros(width, 3 * width, device=dev)
    b = torch.zeros(3 * width, device=dev)
    mask = torch.ones(B, L, device=dev)
    before = bigru_layer_fwd.launches
    with pytest.raises(ValueError, match="H = 100"):
        bigru_layer_fwd(xg, xg, w, b, w, b, mask)
    assert bigru_layer_fwd.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("B,L", [(192, 80), (864, 33)])
def test_bigru_bwd_weight_gradients_are_deterministic(B, L):
    """Kernel C sums dW_hh and db_hh in a fixed order: two launches give
    the same bits (at MELD's 864 streams, over 112 row splits)."""
    dev = _card()
    args, g = _bigru_args(dev, B, L, 17)
    ys_hg = bigru_forward(*args, with_hg=True)
    dy = [torch.randn(B, L, H, generator=g).to(dev) for _ in range(2)]
    first = [t.clone() for t in
             bigru_layer_bwd(*args, *ys_hg[:2], *dy, *ys_hg[2:])]
    second = bigru_layer_bwd(*args, *ys_hg[:2], *dy, *ys_hg[2:])
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _gcnii_args(dev, B, L, nl, reason, seed):
    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(max(1, L // 4), L + 1, (B,), generator=g)
    lengths[0] = L
    umask = (torch.arange(L)[None] < lengths[:, None]).float()
    feats = [torch.randn(B, L, 200, generator=g) * umask[..., None]
             for _ in range(3)]
    adj = mm_big_adjacency(feats, umask).to(dev)
    N = 3 * L
    u = lambda *s: (torch.rand(*s, generator=g) * 0.2 - 0.1).to(dev)
    h = torch.relu(torch.randn(B, N, H, generator=g)).to(dev)
    theta = torch.log(0.5 / torch.arange(1, nl + 1) + 1.0).to(dev)
    lstm = (u(4 * H, H).t(), u(4 * H, H).t(), u(4 * H)) if reason \
        else (None, None, None)
    return (adj, h, h, u(nl, 2 * H, H), theta, *lstm), g


@pytest.mark.gpu
@pytest.mark.parametrize("reason", [True, False])
@pytest.mark.parametrize("B,L", [(1, 200), (2, 13)])
def test_gcnii_kernel_matches_plain(B, L, reason):
    dev = _card()
    args, _ = _gcnii_args(dev, B, L, 16, reason, B * 1000 + L)
    if not reason:
        args = args[:5]
    got = gcnii_stack_fwd(*args, alpha=0.2, reason=reason)
    torch.cuda.synchronize()
    want = gcnii_stack_plain(*args, alpha=0.2, reason=reason)
    # f32 on both sides over 16 layers; only the summation order differs.
    # The reason skip grows h to O(10), so the bound scales with it.
    scale = float(want.abs().max().clamp(min=1.0))
    torch.testing.assert_close(got, want, atol=1e-5 * scale, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("reason", [True, False])
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("L,nl", [(L, nl) for L in (8, 43, 64, 200)
                                  for nl in (2, 16)] + [(8, 64), (64, 64)])
def test_gcnii_resident_matches_plain(L, B, reason, nl):
    """Kernel B's resident design (the whole stack in one launch, one
    cluster a dialogue) at N = 24, 129 (ragged), 192 and 600, one and two
    dialogues (the second shorter, with masked nodes), and at MELD's 64
    layers: against the plain version, bit-equal over two launches, one
    launch a call."""
    dev = _card()
    args, _ = _gcnii_args(dev, B, L, nl, reason, 17 * B + L + nl)
    if not reason:
        args = args[:5]
    args += (None,) * (8 - len(args))
    opts = dict(alpha=0.2, reason=reason, rate=0.0, seed=None,
                residuals=None, design=DESIGNS["resident"])
    before = gcnii_stack_fwd.launches
    got = gcnii_forward(*args, **opts)
    again = gcnii_forward(*args, **opts)
    torch.cuda.synchronize()
    assert gcnii_stack_fwd.launches - before == 2 == 2 * gcnii_fwd_launches(
        nl, reason, DESIGNS["resident"])
    assert torch.equal(got, again)
    want = gcnii_stack_plain(*args[:5], *args[5:] if reason else (),
                             alpha=0.2, reason=reason)
    scale = float(want.abs().max().clamp(min=1.0))
    torch.testing.assert_close(got, want, atol=1e-5 * scale, rtol=0)


def _train_fwd(args, reason, rate, seed, plain):
    adj, h = args[0], args[1]
    B, N, _ = h.shape
    nl = args[3].shape[0]
    res = [torch.empty(B, nl, N, H, device=h.device) for _ in RESIDUALS]
    for r in res[1:3]:
        r.zero_()
    fwd = gcnii_stack_plain if plain else gcnii_stack_fwd
    out = fwd(*args, alpha=0.2, reason=reason, rate=rate, seed=seed,
              residuals=res)
    return out, res


def _kernel_d_decisions(args, res, reason, tol):
    """Kernel D's ReLU decisions on the residuals ``res``, one bool (B, N,
    H) tensor a layer.  Its hi and pre products are kernel B's tiled F2
    and F3 on the same operands, so kernel B's tiled design, one layer at
    a time on the stored h1 without reason or dropout, returns relu(pre) as
    kernel D forms pre.  They may differ from the plain recompute's
    decisions only where pre is within ``tol`` of 0, where two f32
    summation orders may round either way."""
    adj, _, h0, W, theta, ih, hh, lb = args
    masks = []
    for l in range(W.shape[0]):
        masks.append(gcnii_forward(
            adj, res[3][:, l].contiguous(), h0, W[l:l + 1], theta[l:l + 1],
            None, None, None, alpha=0.2, reason=False, rate=0.0, seed=None,
            residuals=None, design=DESIGNS["tiled"]) > 0)
        h1 = (_lstm_step(res[0][:, l], res[1][:, l], res[2][:, l], ih, hh,
                         lb)[0] if reason else res[0][:, l])
        hi = adj @ h1
        pre = theta[l] * (hi @ W[l, :H] + h0 @ W[l, H:]) \
            + (1.0 - theta[l]) * (0.8 * hi + 0.2 * h0)
        differ = masks[l] != (pre > 0.0)
        if bool(differ.any()):
            assert float(pre[differ].abs().max()) <= tol, l
    return masks


@pytest.mark.gpu
@pytest.mark.parametrize("reason", [True, False])
@pytest.mark.parametrize("B,L,nl", [(32, 80, 16), (1, 9, 16), (3, 43, 16),
                                    (32, 33, 64)])
def test_gcnii_train_kernels_match_plain(B, L, nl, reason):
    """Kernel B's training mode (dropout 0.4, residuals) and kernel D at the
    training shapes (IEMOCAP's B = 32, N = 240, 16 layers; MELD's B = 32,
    N = 99, 64 layers, whose second 64-row tile is ragged) and ragged ones
    (N = 27; N = 129 crosses every tile edge of kernel D's products), both
    against their plain versions on identical residuals; kernel D at its
    own ReLU decisions (:func:`_kernel_d_decisions`)."""
    dev = _card()
    args, g = _gcnii_args(dev, B, L, nl, reason, 31 * B + L)
    seed = torch.tensor([0x5DEECE66D1234], dtype=torch.int64, device=dev)
    out, res = _train_fwd(args, reason, 0.4, seed, plain=False)
    torch.cuda.synchronize()
    want, want_res = _train_fwd(args, reason, 0.4, seed, plain=True)
    scale = float(want.abs().max().clamp(min=1.0))
    torch.testing.assert_close(out, want, atol=1e-5 * scale, rtol=0)
    for a, b in zip(res, want_res):
        torch.testing.assert_close(a, b, atol=1e-5 * scale, rtol=0)

    adj, _, h0, W, theta, ih, hh, lb = args
    dh = torch.randn(out.shape, generator=g).to(dev)
    got = gcnii_stack_bwd(adj, h0, W, theta, ih, hh, lb, res, dh,
                          alpha=0.2, reason=reason, rate=0.4, seed=seed)
    torch.cuda.synchronize()
    masks = _kernel_d_decisions(args, res, reason, 1e-5 * scale)
    ref = gcnii_stack_bwd_plain(adj, h0, W, theta, ih, hh, lb, res, dh,
                                alpha=0.2, reason=reason, rate=0.4, seed=seed,
                                relu_masks=masks)
    for name, a, b in zip(("d_adj", "d_h", "d_h0", "dW", "dW_ih", "dW_hh",
                           "db"), got, ref):
        # f32; sums over up to B N rows and nl layers in another order
        s = float(b.abs().max().clamp(min=1e-6))
        assert float((a - b).abs().max()) <= 1e-4 * s, name


@pytest.mark.gpu
@pytest.mark.parametrize("reason", [True, False])
@pytest.mark.parametrize("B,L", [(1, 64), (32, 80)])
def test_nonvariant_stack_on_the_fold_matches_the_unfolded_plain(B, L,
                                                                 reason):
    """The original GCNII update (``variant=False``, W (nl, H, H)): kernel B
    on W's fold serving (one dialogue: N = 192) and in training mode
    (dropout 0.4; B = 32: N = 240), and kernel D with the fold's backward
    through autograd, against the unfolded plain version: the output, and
    every operand's gradient at kernel D's ReLU decisions."""
    dev = _card()
    args, g = _gcnii_args(dev, B, L, 16, reason, 97 * B + L)
    W = (torch.rand(16, H, H, generator=g) * 0.2 - 0.1).to(dev)
    args = (*args[:3], W, args[4], *(args[5:] if reason else (None,) * 3))
    kw = dict(alpha=0.2, reason=reason, variant=False)
    got = gcnii_stack_fwd(*args, **kw)
    torch.cuda.synchronize()
    want = gcnii_stack_plain(*args, **kw)
    scale = float(want.abs().max().clamp(min=1.0))
    torch.testing.assert_close(got, want, atol=1e-5 * scale, rtol=0)

    seed = torch.tensor([0x5DEECE66D4321], dtype=torch.int64, device=dev)
    kw.update(rate=0.4, seed=seed)
    res = [torch.zeros(B, 16, 3 * L, H, device=dev) for _ in RESIDUALS]
    with torch.no_grad():
        gcnii_stack_fwd(*args, residuals=res, **kw)
    folded = (*args[:3], fold_weights(W, 0.2), *args[4:])
    masks = _kernel_d_decisions(folded, res, reason, 1e-5 * scale)
    dh = torch.randn(B, 3 * L, H, generator=g).to(dev)
    live = [i for i, t in enumerate(args) if t is not None and i != 4]

    def step(fn, **more):
        leaves = [t if t is None else t.detach().clone().requires_grad_()
                  for t in args]
        out = fn(*leaves, **kw, **more)
        return out, torch.autograd.grad(out, [leaves[i] for i in live], dh)
    before = (gcnii_stack_fwd.launches, gcnii_stack_bwd.launches)
    out, grads = step(gcnii_stack_fwd)
    torch.cuda.synchronize()
    design = _design(B, 3 * L, _sm_count(dev))
    assert (gcnii_stack_fwd.launches - before[0],
            gcnii_stack_bwd.launches - before[1]) == (
        gcnii_fwd_launches(16, reason, design),
        gcnii_bwd_launches(16, reason))
    out_p, grads_p = step(gcnii_stack_plain, relu_masks=masks)
    torch.testing.assert_close(out, out_p, atol=1e-5 * scale, rtol=0)
    for i, a, b in zip(live, grads, grads_p):
        # f32; sums over up to B N rows and 16 layers in another order
        s = float(b.abs().max().clamp(min=1e-6))
        assert float((a - b).abs().max()) <= 1e-4 * s, i


@pytest.mark.gpu
@pytest.mark.parametrize("design", sorted(DESIGNS))
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("reason", [True, False])
def test_gcnii_fwd_ragged_in_every_design(reason, train, design):
    """Kernel B at N = 129 nodes (L = 43, two dialogues), which no tile
    edge divides, in serve mode and in training mode (dropout 0.4,
    residuals), in each of its designs, against the plain version."""
    dev = _card()
    args, _ = _gcnii_args(dev, 2, 43, 16, reason, 4343)
    if not reason:
        args = args[:5]
    seed = torch.tensor([77], dtype=torch.int64, device=dev)
    opts = dict(alpha=0.2, reason=reason, rate=0.4 if train else 0.0,
                seed=seed if train else None)
    B, N = args[1].shape[:2]
    slabs = lambda: [torch.zeros(B, 16, N, H, device=dev)
                     for _ in RESIDUALS] if train else None
    res, want_res = slabs(), slabs()
    got = gcnii_forward(*args, *(None,) * (8 - len(args)),
                        residuals=res, design=DESIGNS[design], **opts)
    torch.cuda.synchronize()
    want = gcnii_stack_plain(*args, residuals=want_res, **opts)
    scale = float(want.abs().max().clamp(min=1.0))
    torch.testing.assert_close(got, want, atol=1e-5 * scale, rtol=0)
    for a, b in zip(res or [], want_res or []):
        torch.testing.assert_close(a, b, atol=1e-5 * scale, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("train,L,want", [
    (False, 64, "resident"), (False, 200, "rowwise"), (True, 80, "tiled")])
@pytest.mark.parametrize("reason", [True, False])
def test_gcnii_fwd_is_deterministic_and_counts_its_launches(reason, train, L,
                                                            want):
    """Two calls of kernel B give the same bits in the output and every
    residual, and each call launches the documented number of kernels (the
    training batch takes the tiled design; one dialogue the resident one up
    to N = 384 nodes, the row-wise one at N = 600)."""
    dev = _card()
    B, nl = (32, 16) if train else (1, 16)
    args, _ = _gcnii_args(dev, B, L, nl, reason, 53)
    if not reason:
        args = args[:5]
    seed = torch.tensor([99], dtype=torch.int64, device=dev)
    opts = dict(alpha=0.2, reason=reason, rate=0.4 if train else 0.0,
                seed=seed if train else None)

    def run():
        res = ([torch.zeros(B, nl, 3 * L, H, device=dev) for _ in RESIDUALS]
               if train else None)
        before = gcnii_stack_fwd.launches
        out = gcnii_stack_fwd(*args, residuals=res, **opts)
        return [out, *(res or [])], gcnii_stack_fwd.launches - before

    first, n1 = run()
    second, n2 = run()
    torch.cuda.synchronize()
    design = _design(B, 3 * L, _sm_count(dev))
    assert design == DESIGNS[want]
    assert n1 == n2 == gcnii_fwd_launches(nl, reason, design)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_gcnii_fwd_refuses_what_it_does_not_take():
    """A hidden size above 128 or residual slabs of another shape raise
    before any launch."""
    dev = _card()
    args, _ = _gcnii_args(dev, 2, 5, 4, True, 59)
    adj, h, h0, W, theta, ih, hh, lb = args
    B, N, _ = h.shape
    nl, wide = W.shape[0], 129
    before = gcnii_stack_fwd.launches
    with pytest.raises(ValueError, match="128"):
        gcnii_stack_fwd(adj, torch.zeros(B, N, wide, device=dev),
                        torch.zeros(B, N, wide, device=dev),
                        torch.zeros(nl, 2 * wide, wide, device=dev), theta,
                        torch.zeros(wide, 4 * wide, device=dev),
                        torch.zeros(wide, 4 * wide, device=dev),
                        torch.zeros(4 * wide, device=dev), alpha=0.2,
                        reason=True)
    short = [torch.zeros(B, nl - 1, N, H, device=dev) for _ in RESIDUALS]
    with pytest.raises(ValueError, match="residual h"):
        gcnii_stack_fwd(*args, alpha=0.2, reason=True, residuals=short)
    res = [torch.zeros(B, nl, N, H, device=dev) for _ in RESIDUALS]
    res[3] = torch.zeros(B, nl, N, H + 1, device=dev)[..., :H]
    with pytest.raises(ValueError, match="contiguous"):
        gcnii_stack_fwd(*args, alpha=0.2, reason=True, residuals=res)
    assert gcnii_stack_fwd.launches == before


def _gcnii_bwd_inputs(dev, B, L, reason, seed):
    args, g = _gcnii_args(dev, B, L, 16, reason, seed)
    rate_seed = torch.tensor([seed], dtype=torch.int64, device=dev)
    out, res = _train_fwd(args, reason, 0.4, rate_seed, plain=False)
    adj, _, h0, W, theta, ih, hh, lb = args
    dh = torch.randn(out.shape, generator=g).to(dev)
    return (adj, h0, W, theta, ih, hh, lb, res, dh), dict(
        alpha=0.2, reason=reason, rate=0.4, seed=rate_seed)


# the bf16 mode against its plain version: both round at the TPU kernel's
# points, so they differ by f32 summation order, and where that moves a
# value across a bf16 rounding boundary, by one bf16 step of that value,
# which moves the outputs it reaches (through adj, every node of its
# dialogue) by up to ~2e-4 of their scale (B = 32, N = 240, 16 layers: 37
# of 768000 elements past 1e-4 of the scale, all from one such flip).  So
# at most BF16_SHARE of the elements may lie past BF16_RTOL of the scale
# (past one bf16 step of the element beside it, for d_adj, d_h0 and dW,
# which both round to bf16), and none past BF16_CAP of the scale (beside
# that step).  The f32 mode is ~1e-3 of the scale from the bf16 function
# in most elements, and fails this.
BF16_RTOL, BF16_SHARE, BF16_CAP = 1e-4, 1e-3, 1e-3


def _bf16_agree(got, want, rounded=False, scale=None):
    s = float(want.abs().max().clamp(min=1e-6)) if scale is None else scale
    d = (got.float() - want.float()).abs()
    step = 2.0 ** -7 * want.float().abs() if rounded else 0.0
    share = float((d > BF16_RTOL * s + step).float().mean())
    assert share <= BF16_SHARE and bool((d <= BF16_CAP * s + step).all()), (
        share, float(d.max()), s)


def _bf16_slabs(*lead, nl, N):
    return [torch.zeros(*lead, nl, N, H, device="cuda",
                        dtype=torch.bfloat16) for _ in RESIDUALS_BF16]


def _bf16_bwd_close(got, ref, reason):
    names = ("d_adj", "d_h", "d_h0", "dW", "dW_ih", "dW_hh", "db")
    for name, a, b in zip(names[:7 if reason else 4], got, ref):
        _bf16_agree(a, b, rounded=name in ("d_adj", "d_h0", "dW"))


def _kernel_d_bf16_decisions(tol):
    """Kernel D's ReLU decisions in its last call (its tdpre slab is theta
    times the gradient past the ReLU, zero where the ReLU is off) and the
    plain backward at them.  Where the gradient past the ReLU is not zero,
    each decision that differs from the plain recompute of pre from the
    same bf16 slabs lies within ``tol`` of 0, where two summation orders
    may decide apart."""
    args, kw, tdpre = gcnii_stack_bwd.kept[-1]
    masks = [t != 0 for t in tdpre]
    seen = []
    ref = gcnii_stack_bwd_plain(*args, relu_masks=masks, relu_inputs=seen,
                                **kw)
    for m, (pre, g) in zip(masks, seen):
        differ = (g != 0) & (m != (pre > 0))
        assert float(torch.where(differ, pre.abs(), 0.0).max()) <= tol
    return ref


@pytest.mark.gpu
@pytest.mark.parametrize("reason", [True, False])
@pytest.mark.parametrize("B,L,nl", [(32, 80, 16), (1, 9, 16), (3, 43, 16)])
def test_gcnii_bf16_kernels_match_plain(B, L, nl, reason):
    """The bf16 mode (the TPU training kernel's numerics) of kernel B, in
    training mode (dropout 0.4, the three bf16 residual slabs) and serving
    (rate 0, no slabs), and of kernel D on the kernel's slabs, at the
    training shape (B = 32, N = 240, 16 layers) and ragged ones, against
    their plain bf16 versions; kernel D at its own ReLU decisions, each
    that differs from the plain recompute within the forward's tolerance
    of 0; both bit-equal over two calls, each with its documented launch
    count."""
    dev = _card()
    args, g = _gcnii_args(dev, B, L, nl, reason, 41 * B + L)
    adj, h, h0, W, theta, ih, hh, lb = args
    N = 3 * L
    seed = torch.tensor([0x5DEECE66D1234], dtype=torch.int64, device=dev)
    opts = dict(alpha=0.2, reason=reason, mode="bf16")
    fwd_args = args if reason else args[:5]
    before = gcnii_stack_fwd.launches
    res, res2, res_p = (_bf16_slabs(B, nl=nl, N=N) for _ in range(3))
    out = gcnii_stack_fwd(*fwd_args, rate=0.4, seed=seed, residuals=res,
                          **opts)
    out2 = gcnii_stack_fwd(*fwd_args, rate=0.4, seed=seed, residuals=res2,
                           **opts)
    torch.cuda.synchronize()
    assert gcnii_stack_fwd.launches - before == 2 * gcnii_fwd_launches(
        nl, reason, DESIGNS["tiled"])
    assert torch.equal(out, out2)
    assert all(torch.equal(a, b) for a, b in zip(res, res2))
    want = gcnii_stack_plain(*fwd_args, rate=0.4, seed=seed,
                             residuals=res_p, **opts)
    scale = float(want.abs().max().clamp(min=1.0))
    _bf16_agree(out, want, scale=scale)
    for a, b in zip(res, res_p):
        _bf16_agree(a, b, rounded=True, scale=scale)
    serve = gcnii_stack_fwd(*fwd_args, **opts)
    want = gcnii_stack_plain(*fwd_args, **opts)
    _bf16_agree(serve, want, scale=scale)

    dh = torch.randn(out.shape, generator=g).to(dev)
    bwd_args = (adj, h0, W, theta, ih, hh, lb, res, dh)
    bopts = dict(alpha=0.2, reason=reason, rate=0.4, seed=seed, mode="bf16")
    before = gcnii_stack_bwd.launches
    gcnii_stack_bwd.kept = []
    try:
        got = gcnii_stack_bwd(*bwd_args, **bopts)
        torch.cuda.synchronize()
        ref = _kernel_d_bf16_decisions(BF16_RTOL * scale)
        again = gcnii_stack_bwd(*bwd_args, **bopts)
    finally:
        gcnii_stack_bwd.kept = None
    torch.cuda.synchronize()
    assert gcnii_stack_bwd.launches - before == 2 * gcnii_bwd_launches(
        nl, reason)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for t in (got[0], got[2], got[3]):     # rounded to bf16
        assert torch.equal(t, t.to(torch.bfloat16).float())
    _bf16_bwd_close(got, ref, reason)


@pytest.mark.gpu
def test_gcnii_bf16_config_axis_launch_equals_solo_launches():
    """The bf16 mode of kernels B (training mode) and D over K = 3
    configurations in one call each (B = 8, N = 120, 4 layers, the
    reason-LSTM), the rates {0, 0.2, 0.4} read per configuration: against
    3 solo calls at the static rates, bit for bit (outputs, the bf16
    slabs, every gradient)."""
    from mmdfn_torch.nn.drop_override import make_drop_rate

    dev = _card()
    K, B, L, nl = len(RATES_K), 8, 40, 4
    sets = [_gcnii_args(dev, B, L, nl, True, 600 + k)[0] for k in range(K)]
    theta = sets[0][4]
    per = [torch.stack([s[i] for s in sets]) for i in (0, 1, 2, 3, 5, 6, 7)]
    N = 3 * L
    seed = torch.tensor([0x5DEECE66D1234], dtype=torch.int64, device=dev)
    rate = make_drop_rate(RATES_K, device=dev)
    opts = dict(alpha=0.2, reason=True, mode="bf16")
    res = _bf16_slabs(K, B, nl=nl, N=N)
    before = gcnii_stack_fwd.launches
    out = gcnii_forward(*per[:4], theta, *per[4:], rate=rate, seed=seed,
                        residuals=res, **opts)
    assert gcnii_stack_fwd.launches - before == gcnii_fwd_launches(
        nl, True, DESIGNS["tiled"])
    g = torch.Generator().manual_seed(12)
    dh = torch.randn(K, B, N, H, generator=g).to(dev)
    adj, _, h0, W, ih, hh, lb = per
    got = gcnii_stack_bwd(adj, h0, W, theta, ih, hh, lb, res, dh, rate=rate,
                          seed=seed, **opts)
    torch.cuda.synchronize()
    for k, r in enumerate(RATES_K):
        res_k = _bf16_slabs(B, nl=nl, N=N)
        s_k = seed if r else None
        want = gcnii_forward(*sets[k], rate=r, seed=s_k, residuals=res_k,
                             **opts)
        assert torch.equal(out[k], want), k
        assert all(torch.equal(a[k], b) for a, b in zip(res, res_k)), k
        a_k = sets[k]
        want = gcnii_stack_bwd(a_k[0], a_k[2], a_k[3], theta, *a_k[5:],
                               res_k, dh[k], rate=r, seed=s_k, **opts)
        for a, b in zip(got, want):
            assert torch.equal(a[k], b), k


# the bf16 scan mode against its plain version: both round every op to
# bf16 at the same points and sum each product in f32 in another order;
# where that rounds a value to the neighbouring bf16 number, the two differ
# by one bf16 step of it (on the card, B = 32, N = 240: the forward and
# d_adj, d_h, d_h0 equal, the weight gradients' sums one step apart in at
# most 2.2e-4 of their elements).  So at most SCAN_SHARE of the elements
# may differ, none by more than SCAN_CAP_STEPS bf16 steps of the scale
# (2^-8 of its max |.|; chip_smoke.py's bounds); kernel D's ReLU
# decisions that differ from the plain recompute on its slabs within
# SCAN_DECISION_STEPS steps of max |h| of 0.
SCAN_STEP = 2.0 ** -8
SCAN_SHARE, SCAN_CAP_STEPS, SCAN_DECISION_STEPS = 1e-3, 2.0, 1.0


def _scan_agree(got, want, scale=None):
    s = float(want.abs().max().clamp(min=1e-6)) if scale is None else scale
    d = (got.float() - want.float()).abs()
    share = float((d > 0).float().mean())
    assert share <= SCAN_SHARE and float(d.max()) <= (
        SCAN_CAP_STEPS * SCAN_STEP * s), (share, float(d.max()), s)


def _on_bf16_grid(*ts):
    return all(torch.equal(t, t.to(torch.bfloat16).float()) for t in ts)


@pytest.mark.gpu
@pytest.mark.parametrize("reason,variant,last_f32", [
    (True, True, False), (False, True, True), (True, False, False),
    (False, False, False)])
@pytest.mark.parametrize("B,L,nl", [(32, 80, 16), (3, 43, 4)])
def test_gcnii_scan_kernels_match_plain(B, L, nl, reason, variant, last_f32):
    """The bf16 scan mode (JAX's bf16 layer scan) of kernel B, in training
    mode (dropout 0.4, the three bf16 slabs) and serving, and of kernel D
    on the kernel's slabs, against the plain scan (ops/gcnii.py:
    _scan_plain, _scan_bwd_plain) in the wirings the port sends to it (the
    reason-LSTM on and off, ``variant=False`` on W unfolded, GF2's last
    dropout in f32), at the training shape and a ragged one: kernel D at
    its own ReLU decisions, each that differs from the plain recompute
    within the forward's tolerance of 0; every output a bf16 value (but
    the f32 last dropout's); both bit-equal over two calls, each with its
    documented launch count."""
    from mmdfn_torch.ops.gcnii import SCAN

    dev = _card()
    args, g = _gcnii_args(dev, B, L, nl, reason, 53 * B + L)
    adj, h, h0, W, theta, ih, hh, lb = args
    if reason:
        lb = torch.stack([lb, (torch.rand(4 * H, generator=g) * 0.2
                               - 0.1).to(dev)])
    if not variant:
        W = W[:, :H].contiguous()
    N = 3 * L
    seed = torch.tensor([0x5DEECE66D4321], dtype=torch.int64, device=dev)
    opts = dict(alpha=0.1, reason=reason, mode=SCAN, variant=variant,
                last_drop_f32=last_f32)
    fwd_args = (adj, h, h0, W, theta, ih, hh, lb)
    before = gcnii_stack_fwd.launches
    res, res2, res_p = (_bf16_slabs(B, nl=nl, N=N) for _ in range(3))
    out = gcnii_stack_fwd(*fwd_args, rate=0.4, seed=seed, residuals=res,
                          **opts)
    out2 = gcnii_stack_fwd(*fwd_args, rate=0.4, seed=seed, residuals=res2,
                           **opts)
    torch.cuda.synchronize()
    assert gcnii_stack_fwd.launches - before == 2 * gcnii_fwd_launches(
        nl, reason, DESIGNS["tiled"], SCAN)
    assert torch.equal(out, out2)
    assert all(torch.equal(a, b) for a, b in zip(res, res2))
    assert last_f32 or _on_bf16_grid(out)
    want = gcnii_stack_plain(*fwd_args, rate=0.4, seed=seed,
                             residuals=res_p, **opts)
    scale = float(want.abs().max().clamp(min=1.0))
    _scan_agree(out, want, scale)
    for a, b in zip(res, res_p):
        _scan_agree(a, b, scale)
    serve = gcnii_stack_fwd(*fwd_args, **opts)
    assert _on_bf16_grid(serve)
    _scan_agree(serve, gcnii_stack_plain(*fwd_args, **opts), scale)

    dh = torch.randn(out.shape, generator=g).to(dev)
    bwd_args = (adj, h0, W, theta, ih, hh, lb, res, dh)
    bopts = dict(opts, rate=0.4, seed=seed)
    before = gcnii_stack_bwd.launches
    gcnii_stack_bwd.kept = []
    try:
        got = gcnii_stack_bwd(*bwd_args, **bopts)
        torch.cuda.synchronize()
        ref = _kernel_d_bf16_decisions(SCAN_DECISION_STEPS * SCAN_STEP
                                       * scale)
        again = gcnii_stack_bwd(*bwd_args, **bopts)
    finally:
        gcnii_stack_bwd.kept = None
    torch.cuda.synchronize()
    assert gcnii_stack_bwd.launches - before == 2 * gcnii_bwd_launches(
        nl, reason, SCAN)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    n = 7 if reason else 4
    assert _on_bf16_grid(*got[:n])
    for a, b in zip(got[:n], ref[:n]):
        _scan_agree(a, b)


@pytest.mark.gpu
def test_gcnii_scan_config_axis_launch_equals_solo_launches():
    """The bf16 scan mode of kernels B (training mode) and D over K = 3
    configurations in one call each (B = 8, N = 120, 4 layers, the
    reason-LSTM), the rates {0, 0.2, 0.4} read per configuration: against
    3 solo calls at the static rates, bit for bit (outputs, the bf16
    slabs, every gradient)."""
    from mmdfn_torch.nn.drop_override import make_drop_rate
    from mmdfn_torch.ops.gcnii import SCAN

    dev = _card()
    K, B, L, nl = len(RATES_K), 8, 40, 4
    sets = []
    for k in range(K):
        a, g = _gcnii_args(dev, B, L, nl, True, 700 + k)
        sets.append((*a[:7], torch.stack([a[7], a[7].flip(0)])))
    theta = sets[0][4]
    per = [torch.stack([s[i] for s in sets]) for i in (0, 1, 2, 3, 5, 6, 7)]
    N = 3 * L
    seed = torch.tensor([0x5DEECE66D4321], dtype=torch.int64, device=dev)
    rate = make_drop_rate(RATES_K, device=dev)
    opts = dict(alpha=0.1, reason=True, mode=SCAN)
    res = _bf16_slabs(K, B, nl=nl, N=N)
    out = gcnii_forward(*per[:4], theta, *per[4:], rate=rate, seed=seed,
                        residuals=res, **opts)
    dh = torch.randn(K, B, N, H, generator=g).to(dev)
    adj, _, h0, W, ih, hh, lb = per
    got = gcnii_stack_bwd(adj, h0, W, theta, ih, hh, lb, res, dh, rate=rate,
                          seed=seed, **opts)
    torch.cuda.synchronize()
    for k, r in enumerate(RATES_K):
        res_k = _bf16_slabs(B, nl=nl, N=N)
        s_k = seed if r else None
        want = gcnii_forward(*sets[k], rate=r, seed=s_k, residuals=res_k,
                             **opts)
        assert torch.equal(out[k], want), k
        assert all(torch.equal(a[k], b) for a, b in zip(res, res_k)), k
        a_k = sets[k]
        want = gcnii_stack_bwd(a_k[0], a_k[2], a_k[3], theta, *a_k[5:],
                               res_k, dh[k], rate=r, seed=s_k, **opts)
        for a, b in zip(got, want):
            assert torch.equal(a[k], b), k


@pytest.mark.gpu
@pytest.mark.parametrize("reason", [True, False])
def test_gcnii_bwd_is_deterministic(reason):
    """Kernel D sums the weight gradients over row splits in a fixed order
    and d_adj layer by layer, with no atomics: two launches give the same
    bits in every output."""
    dev = _card()
    args, opts = _gcnii_bwd_inputs(dev, 32, 80, reason, 41)
    first = [t.clone() for t in gcnii_stack_bwd(*args, **opts)]
    second = gcnii_stack_bwd(*args, **opts)
    torch.cuda.synchronize()
    for name, a, b in zip(("d_adj", "d_h", "d_h0", "dW", "dW_ih", "dW_hh",
                           "db"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.gpu
def test_gcnii_bwd_refuses_what_it_does_not_take():
    """A hidden size above 128 or a non-f32 input raises before any launch."""
    dev = _card()
    args, opts = _gcnii_bwd_inputs(dev, 2, 5, True, 43)
    before = gcnii_stack_bwd.launches
    adj, h0, W, theta, ih, hh, lb, res, dh = args
    B, N, _ = h0.shape
    nl, wide = W.shape[0], 129
    big = [torch.zeros(B, nl, N, wide, device=dev) for _ in RESIDUALS]
    with pytest.raises(ValueError, match="128"):
        gcnii_stack_bwd(adj, torch.zeros(B, N, wide, device=dev),
                        torch.zeros(nl, 2 * wide, wide, device=dev), theta,
                        torch.zeros(wide, 4 * wide, device=dev),
                        torch.zeros(wide, 4 * wide, device=dev),
                        torch.zeros(4 * wide, device=dev), big,
                        torch.zeros(B, N, wide, device=dev), **opts)
    with pytest.raises(ValueError, match="float32"):
        gcnii_stack_bwd(adj, h0.double(), W, theta, ih, hh, lb, res, dh,
                        **opts)
    with pytest.raises(ValueError, match="float32"):
        gcnii_stack_bwd(adj, h0, W, theta, ih, hh, lb, res, dh.half(),
                        **opts)
    assert gcnii_stack_bwd.launches == before


@pytest.mark.gpu
def test_gcnii_dropout_mask_is_the_plain_philox_mask():
    """With W = 0, alpha = 1 and no reason, layer l's output is
    keep_l * (1 - theta_l) h0 / (1 - rate), so the residual of layer l + 1
    (and the final output) shows the kernel's mask exactly."""
    dev = _card()
    B, N, nl, rate = 32, 240, 16, 0.4
    g = torch.Generator().manual_seed(5)
    h0 = (torch.rand(B, N, H, generator=g) + 0.5).to(dev)
    adj = torch.rand(B, N, N, generator=g).to(dev) / N
    theta = torch.log(0.5 / torch.arange(1, nl + 1) + 1.0).to(dev)
    W = torch.zeros(nl, 2 * H, H, device=dev)
    seed = torch.tensor([987654321987], dtype=torch.int64, device=dev)
    res = [torch.zeros(B, nl, N, H, device=dev) for _ in RESIDUALS]
    out = gcnii_stack_fwd(adj, h0, h0, W, theta, alpha=1.0, reason=False,
                          rate=rate, seed=seed, residuals=res)
    torch.cuda.synchronize()
    for l in range(nl):
        got = (res[0][:, l + 1] if l + 1 < nl else out) != 0
        want = philox.keep_mask(seed, rate, B, l, N, H)
        assert torch.equal(got, want), l
    frac = float(want.float().mean())
    assert abs(frac - (1 - rate)) < 0.01


@pytest.mark.gpu
def test_plain_ops_switch_runs_the_plain_versions_on_the_card():
    dev = _card()
    g = torch.Generator().manual_seed(7)
    B, L = 2, 5
    xg = torch.randn(B, L, 3 * H, generator=g).to(dev)
    w = (torch.rand(3 * H, H, generator=g) * 0.2 - 0.1).to(dev).t()
    b = torch.zeros(3 * H, device=dev)
    mask = torch.ones(B, L, device=dev)
    before = bigru_layer_fwd.launches
    with plain_ops():
        got = bigru_layer_fwd(xg, xg, w, b, w, b, mask)
    assert bigru_layer_fwd.launches == before      # nothing was launched
    want = bigru_layer_plain(xg, xg, w, b, w, b, mask)
    for a, c in zip(got, want):
        assert torch.equal(a, c)                   # the same plain ops
    bigru_layer_fwd(xg, xg, w, b, w, b, mask)      # the switch is off again
    assert bigru_layer_fwd.launches == before + 1


@pytest.mark.gpu
def test_backward_on_the_card_reaches_every_parameter():
    """The regression test for kernel outputs detached from autograd: one
    training step of the 16-layer flagship on the card gives every
    parameter a nonzero gradient, through kernels C and D, and the same
    gradients as the plain versions under autograd."""
    from mmdfn_torch import ops
    from mmdfn_torch.config import flagship_config
    from mmdfn_torch.data.batching import collate
    from mmdfn_torch.data.datasets import IEMOCAPDataset
    from mmdfn_torch.data.synthetic import make_synthetic_iemocap_pickle
    from mmdfn_torch.train import Trainer
    from mmdfn_torch.train.trainer import prepare_inputs

    dev = _card()
    cfg = flagship_config(seed=3)
    cfg.class_weight = True
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        make_synthetic_iemocap_pickle(f"{tmp}/iem.pkl", n_train=3, n_test=1,
                                      min_len=5, max_len=9, seed=3)
        dias = IEMOCAPDataset(f"{tmp}/iem.pkl", train=True).dialogues()
    inputs = prepare_inputs(collate(dias, 3, 9, 2), dev)

    def step(plain):
        tr = Trainer(cfg, device=dev)
        before = dict(ops.launch_counts())
        if plain:
            with ops.plain_ops():
                loss, _ = tr.train_step(inputs, seed=11)
        else:
            loss, _ = tr.train_step(inputs, seed=11)
        torch.cuda.synchronize()
        used = {k: v - before[k] for k, v in ops.launch_counts().items()}
        return float(loss), {n: p.grad for n, p in
                             tr.model.named_parameters()}, used

    loss, grads, used = step(plain=False)
    assert all(v > 0 for v in used.values()), used
    for name, g in grads.items():
        assert g is not None and bool(g.abs().max() > 0), name
    ref_loss, ref, used = step(plain=True)
    assert not any(used.values())
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    for name, g in grads.items():
        scale = float(ref[name].abs().max())
        assert float((g - ref[name]).abs().max()) <= 1e-4 * scale, name


def _gf2_stack_args(dev, B, L, nl, seed):
    """The GCNII stack's operands as GF2 gives them: the raw-arccos graph
    with constant cross edges, no reason-LSTM, and an entry h that differs
    from the anchor h0 (here independent of it)."""
    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(20, L + 1, (B,), generator=g)
    lengths[0] = L
    umask = (torch.arange(L)[None] < lengths[:, None]).float()
    feats = [torch.randn(B, L, 200, generator=g) * umask[..., None]
             for _ in range(3)]
    adj = mm_big_adjacency(feats, umask, variant="arccos",
                           cross_constant=0.99999).to(dev)
    N = 3 * L
    h = torch.relu(torch.randn(B, N, H, generator=g)).to(dev)
    h0 = torch.relu(torch.randn(B, N, H, generator=g)).to(dev)
    W = (torch.rand(nl, 2 * H, H, generator=g) * 0.2 - 0.1).to(dev)
    theta = torch.log(0.5 / torch.arange(1, nl + 1) + 1.0).to(dev)
    return (adj, h, h0, W, theta, None, None, None), g


@pytest.mark.gpu
def test_gcnii_kernels_at_gf2s_wiring_match_plain():
    """Kernels B (training mode) and D at GF2's shapes: 64 layers without
    the reason-LSTM, B = 32, N = 240, dropout 0.4, with independent h and
    h0, against their plain versions: the output, the residuals and every
    gradient, d_h0 included; kernel D at its own ReLU decisions."""
    dev = _card()
    args, g = _gf2_stack_args(dev, 32, 80, 64, 9)
    seed = torch.tensor([0x2545F4914F6CDD1D], dtype=torch.int64, device=dev)
    out, res = _train_fwd(args, False, 0.4, seed, plain=False)
    torch.cuda.synchronize()
    want, want_res = _train_fwd(args, False, 0.4, seed, plain=True)
    scale = float(want.abs().max().clamp(min=1.0))
    torch.testing.assert_close(out, want, atol=1e-5 * scale, rtol=0)
    for a, b in zip(res, want_res):
        torch.testing.assert_close(a, b, atol=1e-5 * scale, rtol=0)
    adj, _, h0, W, theta = args[:5]
    dh = torch.randn(out.shape, generator=g).to(dev)
    got = gcnii_stack_bwd(adj, h0, W, theta, None, None, None, res, dh,
                          alpha=0.2, reason=False, rate=0.4, seed=seed)
    torch.cuda.synchronize()
    masks = _kernel_d_decisions(args, res, False, 1e-5 * scale)
    ref = gcnii_stack_bwd_plain(adj, h0, W, theta, None, None, None, res, dh,
                                alpha=0.2, reason=False, rate=0.4, seed=seed,
                                relu_masks=masks)
    for name, a, b in zip(("d_adj", "d_h", "d_h0", "dW"), got, ref):
        s = float(b.abs().max().clamp(min=1e-6))
        assert float((a - b).abs().max()) <= 1e-4 * s, name


@pytest.mark.gpu
def test_gcnii_training_call_at_rate_0_takes_no_seed():
    """DeepGCN's wiring: kernel B's training mode and kernel D at rate 0
    with ``seed=None`` under autograd (entry and anchor distinct), against
    autograd through the plain version."""
    dev = _card()
    args, g = _gf2_stack_args(dev, 4, 30, 16, 5)
    leaves = [a.clone().requires_grad_() for a in args[:4]]
    before = (gcnii_stack_fwd.launches, gcnii_stack_bwd.launches)
    out = gcnii_stack_fwd(*leaves, args[4], alpha=0.1, reason=False,
                          rate=0.0, seed=None)
    dh = torch.randn(out.shape, generator=g).to(dev)
    got = torch.autograd.grad(out, leaves, dh)
    torch.cuda.synchronize()
    assert gcnii_stack_fwd.launches - before[0] == gcnii_fwd_launches(
        16, False, _design(4, 90, _sm_count(dev)))
    assert gcnii_stack_bwd.launches - before[1] == gcnii_bwd_launches(
        16, False)
    ref_leaves = [a.clone().requires_grad_() for a in args[:4]]
    with plain_ops():
        want = gcnii_stack_fwd(*ref_leaves, args[4], alpha=0.1,
                               reason=False, rate=0.0, seed=None)
        ref = torch.autograd.grad(want, ref_leaves, dh)
    out, want = out.detach(), want.detach()
    scale = float(want.abs().max().clamp(min=1.0))
    torch.testing.assert_close(out, want, atol=1e-5 * scale, rtol=0)
    for name, a, b in zip(("adj", "h", "h0", "W"), got, ref):
        s = float(b.abs().max().clamp(min=1e-6))
        assert float((a - b).abs().max()) <= 1e-4 * s, name


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [
    dict(graph_type="GF2"), dict(graph_type="DeepGCN", reason_flag=True),
    dict(graph_type="GCN3"), dict(graph_type="relation"),
    dict(graph_type="None", mm_fusion_mthd="gated")],
    ids=["GF2", "DeepGCN-reason", "GCN3", "relation", "None-gated"])
def test_family_training_step_on_the_card_matches_plain(kw):
    """One training step of each family on the card (dropout 0.4) against
    the same step with the plain versions: the loss and every parameter's
    gradient, each parameter reached; the families with a GCNII stack
    launch kernels B and D."""
    from mmdfn_torch import ops
    from mmdfn_torch.config import ExperimentConfig
    from mmdfn_torch.data.batching import collate
    from mmdfn_torch.data.datasets import IEMOCAPDataset
    from mmdfn_torch.data.synthetic import make_synthetic_iemocap_pickle
    from mmdfn_torch.train import Trainer
    from mmdfn_torch.train.trainer import prepare_inputs

    dev = _card()
    cfg = ExperimentConfig(Deep_GCN_nlayers=4, dropout=0.4, seed=3,
                           class_weight=True, **kw)
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        make_synthetic_iemocap_pickle(f"{tmp}/iem.pkl", n_train=3, n_test=1,
                                      min_len=5, max_len=9, seed=3)
        dias = IEMOCAPDataset(f"{tmp}/iem.pkl", train=True).dialogues()
    inputs = prepare_inputs(collate(dias, 3, 9, 2), dev)

    def step(plain):
        tr = Trainer(cfg, device=dev)
        before = dict(ops.launch_counts())
        if plain:
            with ops.plain_ops():
                loss, _ = tr.train_step(inputs, seed=11)
        else:
            loss, _ = tr.train_step(inputs, seed=11)
        torch.cuda.synchronize()
        used = {k: v - before[k] for k, v in ops.launch_counts().items()}
        return float(loss), {n: p.grad for n, p in
                             tr.model.named_parameters()}, used

    loss, grads, used = step(plain=False)
    assert used["bigru_fwd"] > 0 and used["bigru_bwd"] > 0, used
    stack = kw["graph_type"] in ("GF2", "DeepGCN")
    assert (used["gcnii_fwd"] > 0 and used["gcnii_bwd"] > 0) == stack, used
    for name, g in grads.items():
        assert g is not None and bool(g.abs().max() > 0), name
    ref_loss, ref, used = step(plain=True)
    assert not any(used.values())
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    for name, g in grads.items():
        scale = float(ref[name].abs().max())
        assert float((g - ref[name]).abs().max()) <= 1e-4 * scale, name


@pytest.mark.gpu
@pytest.mark.parametrize("kw,rows", [
    (dict(graph_type="DeepGCN", mm_fusion_mthd="concat", reason_flag=True),
     {32, 64}),
    (dict(graph_model=False, base_model="GRU"), {32}),
    (dict(graph_model=False, base_model="LSTM"), set()),
    (dict(graph_model=False, base_model="DialogRNN", active_listener=True),
     set())],
    ids=["early-DeepGCN-reason", "GRU", "LSTM", "DialogRNN-listener"])
def test_single_stream_and_baseline_steps_on_the_card_match_plain(kw, rows,
                                                                  monkeypatch):
    """One training step of early-fusion DeepGCN (a,v,l concatenated, the
    LSTM base with the CRN) and of each baseline on the card (B = 32
    dialogues, dropout 0.4) against the same step with the plain versions:
    the loss and every parameter's gradient.  Kernels A and C run at the
    rows each bi-GRU gives them: the text's 32 and the single-stream
    CRN's 64 party streams (B x P); the bi-LSTM and the DialogueRNN launch
    no kernel; early fusion launches kernels B and D."""
    import tempfile

    from mmdfn_torch import ops
    from mmdfn_torch.config import ExperimentConfig
    from mmdfn_torch.data.batching import collate
    from mmdfn_torch.data.datasets import IEMOCAPDataset
    from mmdfn_torch.data.synthetic import make_synthetic_iemocap_pickle
    from mmdfn_torch.nn import rnn
    from mmdfn_torch.train import Trainer
    from mmdfn_torch.train.trainer import prepare_inputs

    dev = _card()
    cfg = ExperimentConfig(Deep_GCN_nlayers=4, dropout=0.4, seed=3,
                           class_weight=True, **kw)
    with tempfile.TemporaryDirectory() as tmp:
        make_synthetic_iemocap_pickle(f"{tmp}/iem.pkl", n_train=32,
                                      n_test=1, min_len=5, max_len=9, seed=3)
        dias = IEMOCAPDataset(f"{tmp}/iem.pkl", train=True).dialogues()
    inputs = prepare_inputs(collate(dias, 32, 9, 2), dev)
    seen = set()
    launch = rnn.bigru_layer_fwd

    def record(xg_f, *args):
        seen.add(xg_f.shape[0])
        return launch(xg_f, *args)
    monkeypatch.setattr(rnn, "bigru_layer_fwd", record)

    def step(plain):
        tr = Trainer(cfg, device=dev)
        before = dict(ops.launch_counts())
        if plain:
            with ops.plain_ops():
                loss, _ = tr.train_step(inputs, seed=11)
        else:
            loss, _ = tr.train_step(inputs, seed=11)
        torch.cuda.synchronize()
        used = {k: v - before[k] for k, v in ops.launch_counts().items()}
        return float(loss), {n: p.grad for n, p in
                             tr.model.named_parameters()}, used

    loss, grads, used = step(plain=False)
    assert seen == rows
    assert (used["bigru_fwd"] > 0 and used["bigru_bwd"] > 0) == bool(rows)
    stack = cfg.graph_model
    assert (used["gcnii_fwd"] > 0 and used["gcnii_bwd"] > 0) == stack, used
    for name, g in grads.items():
        assert g is not None and bool(g.abs().max() > 0), name
    ref_loss, ref, used = step(plain=True)
    assert not any(used.values())
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    for name, g in grads.items():
        scale = float(ref[name].abs().max())
        assert float((g - ref[name]).abs().max()) <= 1e-4 * scale, name


def _history(rows):
    keys = ("epoch", "train_loss", "test_fscore", "test_acc", "test_loss")
    return [{k: r[k] for k in keys} for r in rows]


def _same_run(a, b):
    """Equal epochs, test F-scores and accuracies, and losses within 1e-5
    relative."""
    return len(a) == len(b) and all(
        x["epoch"] == y["epoch"] and x["test_fscore"] == y["test_fscore"]
        and x["test_acc"] == y["test_acc"]
        and all(abs(x[k] - y[k]) <= 1e-5 * abs(y[k])
                for k in ("train_loss", "test_loss"))
        for x, y in zip(a, b))


def _first_step_gaps(cfg, combos, train, dev):
    """A group's first batched step against each configuration's solo
    step, from the same weights on the same batch and seed: for each
    configuration the loss's gap relative to the solo loss, the largest
    gradient gap as a share of that gradient's max |.|, and the largest
    gap of the stepped weights as a share of each tensor's max |.|, less
    what Adam's first step lr g / (|g| + eps) makes of the tensor's
    gradient gap d at each element (lr eps d / (|g| - d + eps)^2, g the
    solo's g + l2 p), away from the elements where |g| <= d (there the
    step's sign may differ)."""
    import dataclasses

    from mmdfn_torch.data.batching import BucketBatcher
    from mmdfn_torch.train import Trainer
    from mmdfn_torch.train.trainer import prepare_inputs
    from mmdfn_torch.train.vmap_sweep import VmapSweep
    from mmdfn_torch.weights import build_model

    group = VmapSweep(cfg, combos, device=dev)
    batch = next(iter(BucketBatcher(train, cfg.batch_size, 2, cfg.buckets,
                                    shuffle=True, seed=cfg.seed).epoch(0)))
    inputs = prepare_inputs(batch, dev)
    losses = group.step(inputs, 0, 0, [True] * len(combos))
    gaps = []
    for k, combo in enumerate(combos):
        cfg_k = dataclasses.replace(group.cfg, **combo)
        tr = Trainer(cfg_k, device=dev, model=build_model(cfg_k, group._init))
        loss, _ = tr.train_step(inputs, tr.step_seed(0, 0))
        grad = weight = 0.0
        for n, p in tr.model.named_parameters():
            if p.grad is None:
                continue
            d = float((group.params[n].grad[k] - p.grad).abs().max())
            grad = max(grad, d / float(p.grad.abs().max()))
            g = (p.grad + cfg_k.l2 * group._init[n].to(dev)).abs()
            adam = cfg_k.lr * 1e-8 * d / (g - d + 1e-8) ** 2
            gap = (group.params[n].detach()[k] - p.detach()).abs() - adam
            weight = max(weight, float(gap.where(g > d, 0.0).max()
                                       / p.detach().abs().max()))
        gaps.append({"loss": float((losses[k] - loss).abs() / loss.abs()),
                     "grad": grad, "weight": weight})
    return gaps


@pytest.mark.gpu
def test_group_on_the_card_equals_its_solo_runs():
    """A group of 2 (dropout 0.2 and 0.4, two learning rates; 4 layers,
    B = 8, 2 epochs), one batched step a batch through kernels A-D,
    against each combo's solo step and ``Trainer.fit``.  cuBLAS's batched
    products and the batched reductions sum in another order than the
    solo step's, so the group is not bit-equal to a run alone: its first
    step holds each configuration's loss within 1e-6 relative, each
    gradient within 1e-5 of its max |.| (measured: 8.2e-8, 2.7e-6) and
    the stepped weights within 1e-6 of each tensor's max |.| beyond what
    Adam's step makes of that gradient gap (:func:`_first_step_gaps`);
    the 2 epochs then hold equal test
    F-scores, accuracies and best epochs and losses within 1e-5 relative
    (their 4 places: one place is 9.4e-6 of these losses, the gap
    measured).  The weights after 2 epochs are not held: where a gradient
    is near 0 Adam's next steps take lr in either direction, and they
    drift to 1.5e-2 of scale."""
    import dataclasses
    import tempfile

    from mmdfn_torch import ops
    from mmdfn_torch.config import ExperimentConfig
    from mmdfn_torch.data.datasets import IEMOCAPDataset
    from mmdfn_torch.data.synthetic import make_synthetic_iemocap_pickle
    from mmdfn_torch.train import Trainer
    from mmdfn_torch.train.vmap_sweep import VmapSweep

    dev = _card()
    with tempfile.TemporaryDirectory() as tmp:
        make_synthetic_iemocap_pickle(f"{tmp}/iem.pkl", n_train=16,
                                      n_test=8, min_len=5, max_len=20,
                                      seed=5)
        train = IEMOCAPDataset(f"{tmp}/iem.pkl", True).dialogues()
        test = IEMOCAPDataset(f"{tmp}/iem.pkl", False).dialogues()
    cfg = ExperimentConfig(Deep_GCN_nlayers=4, reason_flag=True,
                           class_weight=True, batch_size=8, epochs=2)
    combos = [dict(lr=3e-3, l2=1e-4, dropout=0.2),
              dict(lr=1e-3, l2=2e-4, dropout=0.4)]
    for k, gap in enumerate(_first_step_gaps(cfg, combos, train, dev)):
        assert gap["loss"] <= 1e-6 and gap["grad"] <= 1e-5 and \
            gap["weight"] <= 1e-6, (k, gap)
    before = dict(ops.launch_counts())
    group = VmapSweep(cfg, combos, device=dev).run(train, test,
                                                   verbose=False)
    used = {k: v - before[k] for k, v in ops.launch_counts().items()}
    assert all(v > 0 for v in used.values()), used
    for k, combo in enumerate(combos):
        tr = Trainer(dataclasses.replace(cfg, **combo), device=dev)
        solo = tr.fit(train, test, verbose=False)
        assert group.best_epoch[k] == solo.best_epoch
        assert _same_run(group.history[k], _history(solo.history)), (
            group.history[k], solo.history)


RATES_K = (0.0, 0.2, 0.4)   # one configuration at each, in one launch


@pytest.mark.gpu
def test_bigru_config_axis_launch_equals_solo_launches_and_plain():
    """Kernels A (training mode) and C over K = 3 configurations in one
    launch each (B = 32, L = 80, holes in the shared mask) against 3 solo
    launches, bit for bit (both take 1 or 2 rows a block), and against the
    plain versions under vmap: A within 1e-5, C within 1e-5 of each
    gradient's max(1, |.|)."""
    from torch.func import vmap

    from mmdfn_torch.ops.bigru import _rows_per_block

    dev = _card()
    K, B, L = len(RATES_K), 32, 80
    sets = [_bigru_args(dev, B, L, 70 + k)[0] for k in range(K)]
    mask = sets[0][6]
    stack = [torch.stack([s[i] for s in sets]) for i in range(6)]
    assert _rows_per_block(B, _sm_count(dev), K) in (1, 2)
    before = bigru_layer_fwd.launches
    got = bigru_forward(*stack, mask, with_hg=True)
    assert bigru_layer_fwd.launches - before == 1
    for k in range(K):
        want = bigru_forward(*sets[k][:6], mask, with_hg=True)
        for a, b in zip(got, want):
            assert torch.equal(a[k], b), k
    plain = vmap(lambda *a: bigru_layer_plain(*a, mask, with_hg=True))(
        *stack)
    for a, b in zip(got, plain):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)

    g = torch.Generator().manual_seed(9)
    dy = [torch.randn(K, B, L, H, generator=g).to(dev) for _ in range(2)]
    ys_f, ys_b, hg_f, hg_b = got
    before = bigru_layer_bwd.launches
    grads = bigru_layer_bwd(*stack, mask, ys_f, ys_b, *dy, hg_f, hg_b)
    assert bigru_layer_bwd.launches - before == 1
    for k in range(K):
        want = bigru_layer_bwd(*sets[k][:6], mask, ys_f[k], ys_b[k],
                               dy[0][k], dy[1][k], hg_f[k], hg_b[k])
        for a, b in zip(grads, want):
            assert torch.equal(a[k], b), k
    plain = vmap(lambda xf, xb, wf, bf, wb, bb, yf, yb, df, db, hf, hb:
                 bigru_layer_bwd_plain(xf, xb, wf, bf, wb, bb, mask, yf, yb,
                                       df, db, hf, hb))(
        *stack, ys_f, ys_b, *dy, hg_f, hg_b)
    for a, b in zip(grads, plain):
        s = float(b.abs().max().clamp(min=1.0))
        torch.testing.assert_close(a, b, atol=1e-5 * s, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("design", sorted(DESIGNS))
def test_gcnii_config_axis_launch_equals_solo_launches_and_plain(design):
    """Kernel B in training mode and kernel D over K = 3 configurations in
    one call each (B = 8 dialogues of up to 40 turns, 4 layers, the
    reason-LSTM), the rates {0, 0.2, 0.4} read per configuration from
    memory, in each of kernel B's designs: against 3 solo calls at the
    static rates, bit for bit (outputs, residuals, every gradient; the
    rate-0 configuration draws nothing, as its solo call), with each
    call's documented launch count; kernel B against the plain version
    under vmap within 1e-5 of max |h|, kernel D against the plain version
    at its own ReLU decisions within 1e-4 of each gradient's max |.|."""
    from torch.func import vmap

    from mmdfn_torch.nn.drop_override import make_drop_rate

    dev = _card()
    K, B, L, nl = len(RATES_K), 8, 40, 4
    sets = [_gcnii_args(dev, B, L, nl, True, 500 + k)[0] for k in range(K)]
    theta = sets[0][4]
    per = [torch.stack([s[i] for s in sets]) for i in (0, 1, 2, 3, 5, 6, 7)]
    N = 3 * L
    seed = torch.tensor([0x5DEECE66D1234], dtype=torch.int64, device=dev)
    rate = make_drop_rate(RATES_K, device=dev)
    opts = dict(alpha=0.2, reason=True, design=DESIGNS[design])
    slabs = lambda *k: [torch.zeros(*k, B, nl, N, H, device=dev)
                        for _ in RESIDUALS]
    res = slabs(K)
    before = gcnii_stack_fwd.launches
    out = gcnii_forward(*per[:4], theta, *per[4:], rate=rate, seed=seed,
                        residuals=res, **opts)
    torch.cuda.synchronize()
    assert gcnii_stack_fwd.launches - before == gcnii_fwd_launches(
        nl, True, DESIGNS[design])
    solo_res = []
    for k, r in enumerate(RATES_K):
        res_k = slabs()
        want = gcnii_forward(*sets[k], rate=r, seed=seed if r else None,
                             residuals=res_k, **opts)
        assert torch.equal(out[k], want), k
        for a, b in zip(res, res_k):
            assert torch.equal(a[k], b), k
        solo_res.append(res_k)
    plain_res = slabs(K)
    plain = vmap(lambda adj, h, h0, W, ih, hh, b, res, rate:
                 gcnii_stack_plain(adj, h, h0, W, theta, ih, hh, b,
                                   alpha=0.2, reason=True, rate=rate,
                                   seed=seed, residuals=res))(
        *per, plain_res, rate)
    scale = float(plain.abs().max().clamp(min=1.0))
    torch.testing.assert_close(out, plain, atol=1e-5 * scale, rtol=0)
    for a, b in zip(res, plain_res):
        torch.testing.assert_close(a, b, atol=1e-5 * scale, rtol=0)

    g = torch.Generator().manual_seed(11)
    dh = torch.randn(K, B, N, H, generator=g).to(dev)
    adj, _, h0, W, ih, hh, lb = per
    before = gcnii_stack_bwd.launches
    got = gcnii_stack_bwd(adj, h0, W, theta, ih, hh, lb, res, dh, alpha=0.2,
                          reason=True, rate=rate, seed=seed)
    torch.cuda.synchronize()
    assert gcnii_stack_bwd.launches - before == gcnii_bwd_launches(nl, True)
    for k, r in enumerate(RATES_K):
        a_k = sets[k]
        s_k = seed if r else None
        want = gcnii_stack_bwd(a_k[0], a_k[2], a_k[3], theta, *a_k[5:],
                               solo_res[k], dh[k], alpha=0.2, reason=True,
                               rate=r, seed=s_k)
        for a, b in zip(got, want):
            assert torch.equal(a[k], b), k
        masks = _kernel_d_decisions(a_k, solo_res[k], True, 1e-5 * scale)
        ref = gcnii_stack_bwd_plain(a_k[0], a_k[2], a_k[3], theta, *a_k[5:],
                                    solo_res[k], dh[k], alpha=0.2,
                                    reason=True, rate=r, seed=s_k,
                                    relu_masks=masks)
        for name, a, b in zip(("d_adj", "d_h", "d_h0", "dW", "dW_ih",
                               "dW_hh", "db"), got, ref):
            sc = float(b.abs().max().clamp(min=1e-6))
            assert float((a[k] - b).abs().max()) <= 1e-4 * sc, (k, name)


@pytest.mark.gpu
def test_daily_step_on_the_card_matches_its_plain_step():
    """One DailyDialogue training step on the GRU base (JAX's default
    widths, B = 32 token batches, dropout 0.4, the TextCNN's 0.5) against
    the same step with the plain versions: the loss and every parameter's
    gradient; kernels A and C launch once for each of the bi-GRU's two
    layers, kernels B and D not at all."""
    import tempfile

    from mmdfn_torch import ops
    from mmdfn_torch.config import ExperimentConfig
    from mmdfn_torch.data.batching import collate_tokens
    from mmdfn_torch.data.datasets import DailyDialogueDataset
    from mmdfn_torch.data.synthetic import make_synthetic_daily_pickle
    from mmdfn_torch.train import DailyTrainer

    dev = _card()
    cfg = ExperimentConfig(dataset="DailyDialogue", base_model="GRU",
                           dropout=0.4, seed=3)
    with tempfile.TemporaryDirectory() as tmp:
        make_synthetic_daily_pickle(f"{tmp}/daily.pkl", (32, 1, 1),
                                    min_len=3, max_len=35, vocab_size=5000,
                                    seed=3)
        dias = DailyDialogueDataset("train", f"{tmp}/daily.pkl").dialogues()

    def step(plain):
        tr = DailyTrainer(cfg, device=dev)
        inputs = tr._prepare(collate_tokens(dias, 32, 48,
                                            max_words=cfg.max_words))
        before = dict(ops.launch_counts())
        if plain:
            with ops.plain_ops():
                loss, _ = tr.train_step(inputs, seed=11)
        else:
            loss, _ = tr.train_step(inputs, seed=11)
        torch.cuda.synchronize()
        used = {k: v - before[k] for k, v in ops.launch_counts().items()}
        return float(loss), {n: p.grad for n, p in
                             tr.model.named_parameters()}, used

    loss, grads, used = step(plain=False)
    assert used == {"bigru_fwd": 2, "bigru_bwd": 2, "gcnii_fwd": 0,
                    "gcnii_bwd": 0}, used
    for name, g in grads.items():
        assert g is not None and bool(g.abs().max() > 0), name
    ref_loss, ref, used = step(plain=True)
    assert not any(used.values())
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    for name, g in grads.items():
        scale = float(ref[name].abs().max())
        assert float((g - ref[name]).abs().max()) <= 1e-4 * scale, name


@pytest.mark.gpu
def test_raw_input_step_on_the_card_matches_its_plain_step():
    """One training step of the raw-input model (the flagship, 16 layers
    with the reason-LSTM, dropout 0.4, behind the log-mel and DenseNet
    frontends at their default widths) on 4 dialogues of up to 24 turns,
    1 s of 16 kHz audio and a 32 x 32 crop an utterance, against the same
    step with the plain versions: the loss and every parameter's gradient
    (both frontends' included); kernels A-D launch, none in the plain
    step."""
    import numpy as np

    from mmdfn_torch import ops
    from mmdfn_torch.config import flagship_config
    from mmdfn_torch.train import Trainer
    from mmdfn_torch.weights import build_raw_model

    dev = _card()
    cfg = flagship_config(seed=5)
    rng = np.random.default_rng(5)
    B, L = 4, 24
    umask = (np.arange(L)[None] < rng.integers(8, L + 1, (B, 1))).astype(
        np.float32)
    qmask = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (B, L))] \
        * umask[..., None]
    arrays = dict(
        text=rng.standard_normal((B, L, 100), dtype=np.float32)
        * umask[..., None],
        audio=rng.standard_normal((B, L, 16000), dtype=np.float32)
        * umask[..., None],
        visual=rng.standard_normal((B, L, 32, 32, 3), dtype=np.float32),
        qmask=qmask, umask=umask,
        label=(rng.integers(0, 6, (B, L)) * umask).astype(np.int64))
    inputs = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}

    def step(plain):
        tr = Trainer(cfg, device=dev, model=build_raw_model(cfg))
        before = dict(ops.launch_counts())
        if plain:
            with ops.plain_ops():
                loss, _ = tr.train_step(inputs, seed=11)
        else:
            loss, _ = tr.train_step(inputs, seed=11)
        torch.cuda.synchronize()
        used = {k: v - before[k] for k, v in ops.launch_counts().items()}
        return float(loss), {n: p.grad for n, p in
                             tr.model.named_parameters()}, used

    loss, grads, used = step(plain=False)
    assert all(v > 0 for v in used.values()), used
    for name, g in grads.items():
        assert g is not None and bool(g.abs().max() > 0), name
    ref_loss, ref, used = step(plain=True)
    assert not any(used.values())
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    for name, g in grads.items():
        scale = float(ref[name].abs().max())
        assert float((g - ref[name]).abs().max()) <= 1e-4 * scale, name


@pytest.mark.gpu
def test_data_and_model_parallel_steps_on_the_shared_card_match_one_process():
    """Two ranks on the one card over gloo (``runtime/launch.py``,
    ``share_device=True``): a data-parallel step (B = 8 global, 4 a rank)
    through kernels A-D against the one-process step on the same batch,
    and a node-sharded step (2 model ranks; the stack's plain version with
    the sharded product, kernels A and C alone) against the one-process
    plain step: the loss and every gradient, on each rank."""
    import numpy as np

    from mmdfn_torch import ops
    from mmdfn_torch.config import ExperimentConfig
    from mmdfn_torch.data.batching import Batch
    from mmdfn_torch.parallel import workers
    from mmdfn_torch.runtime import launch
    from mmdfn_torch.train import Trainer

    dev = _card()
    B, L = 8, 20
    rng = np.random.default_rng(3)
    lengths = rng.integers(5, L + 1, size=B)
    umask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    qmask = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (B, L))]
    qmask *= umask[..., None]
    feat = lambda D: (rng.standard_normal((B, L, D), dtype=np.float32)
                      * umask[..., None])
    batch = Batch(text=feat(100), visual=feat(342), audio=feat(1582),
                  qmask=qmask, umask=umask,
                  label=(rng.integers(0, 6, (B, L)) * umask).astype(np.int64))
    cfg = ExperimentConfig(Deep_GCN_nlayers=4, reason_flag=True,
                           class_weight=True, batch_size=B, dropout=0.0)

    def one(plain):
        tr = Trainer(cfg, device=dev)
        inputs = tr._put(batch)
        if plain:
            with plain_ops():
                loss, _ = tr.train_step(inputs, 1)
        else:
            loss, _ = tr.train_step(inputs, 1)
        return float(loss), {n: p.grad.cpu().numpy()
                             for n, p in tr.model.named_parameters()}
    want = {"dp": one(False), "tp": one(True)}
    jobs = [(workers.trainer_steps, dict(cfg=cfg, n_data=2, n_model=1,
                                         batches=[batch], seeds=[1],
                                         device="cuda")),
            (workers.trainer_steps, dict(cfg=cfg, n_data=1, n_model=2,
                                         batches=[batch], seeds=[1],
                                         device="cuda"))]
    ranks = launch.run(workers.run_jobs, 2, jobs, device="cuda",
                       share_device=True)
    for r in ranks:
        for got, (loss, grads) in zip(r, (want["dp"], want["tp"])):
            assert abs(got["losses"][0] - loss) <= 1e-5 * abs(loss)
            for n, g in grads.items():
                err = np.abs(got["grads"][n] - g).max()
                assert err <= 1e-4 * np.abs(g).max(), (n, err)
        dp, tp = r[0]["launches"], r[1]["launches"]
        assert all(v > 0 for v in dp.values()), dp
        assert tp["gcnii_fwd"] == tp["gcnii_bwd"] == 0 < tp["bigru_fwd"], tp
