"""``kernel_b_roofline``: kernel B's (the GCNII stack's forward,
``csrc/gcnii_fwd.cu``) share of its roofline in the traced sub-window, in
%: the sum over its calls of each call's least time, over the device time
of its kernels there.  A training step makes one call in training mode
(it writes the residual slabs the backward reads), an evaluation one
call a test batch without them; each on the config axis, K
configurations of B dialogues of N = 3 x bucket nodes.  Nothing where the
sub-window gives kernel B no time.

A call's least time is the larger of its f32 operations at 67 TFLOP/s and
its bytes at 3.35 TB/s (an H100 SXM's published peaks at 700 W).  The
counts, per configuration (R = B N rows, r = 1 with the reason-LSTM): per
layer ``adj @ h1`` (2 B N^2 H), the support products (4 R H^2), the LSTM
step (16 r R H^2), about 20 R H elementwise; bytes: adj, h, h0, W, theta
and the LSTM in, h out, and in training mode the residual slabs (the
pre-layer h and h1, with the LSTM also lh and lc, of every layer)."""

from portbench import trace

PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def bound_s(K, B, N, nl, reason=True, train=True, H=100):
    r = int(reason)
    R = B * N
    flops = nl * (2 * B * N * N * H + (4 + 16 * r) * R * H * H + 20 * R * H)
    nbytes = 4 * (B * N * N + 2 * R * H + nl * (2 * H * H + 1)
                  + r * (2 * 4 * H * H + 4 * H) + R * H
                  + (2 + 2 * r) * nl * R * H * int(train))
    return K * max(flops / PEAK_FP32, nbytes / PEAK_BYTES)


def read(ctx):
    t = ctx.get("trace")
    if not t:
        return None
    spent = trace.seconds_of(t, "gcnii_fwd")
    if spent <= 0:
        return None
    nl = ctx["cfg"]["model"]["Deep_GCN_nlayers"]
    reason = ctx["cfg"]["model"]["reason_flag"]
    K = ctx["K"]
    least = 0.0
    for u in ctx["prof_units"]:
        if u[0] == "step":
            least += bound_s(K, u[1], 3 * u[2], nl, reason)
        else:
            least += sum(bound_s(K, B, 3 * L, nl, reason, train=False)
                         for B, L in u[1])
    return 100.0 * least / spent
