"""``kernel_d_roofline``: kernel D's (the GCNII stack's backward,
``csrc/gcnii_bwd.cu``) share of its roofline in the traced sub-window, in
%: the sum over its calls of each call's least time, over the device time
of its kernels there.  One call a training step, on the config axis: K
configurations of B dialogues of N = 3 x bucket nodes.  Nothing where the
sub-window gives kernel D no time.

A call's least time is the larger of its f32 operations at 67 TFLOP/s and
its bytes at 3.35 TB/s (an H100 SXM's published peaks at 700 W).  The
counts, per configuration (R = B N rows, r = 1 with the reason-LSTM): per
layer ``adj @ h1``, ``adj^T d_hi`` and ``d_hi h1^T`` (6 B N^2 H), the
support products, their transposes and dW (12 R H^2), the LSTM's
recompute, input gradients and weight gradients (48 r R H^2), about 40 R H
elementwise; bytes: adj, h0, W, the LSTM, the four residual slabs and dh
in, d_adj, d_h, d_h0, dW and the LSTM's gradients out, and what the
design keeps between its products, each written once and read once (the
gates and dgates (R, 4H) and the hi and tdpre slabs of every layer, the
weight-gradient partials of the row splits)."""

from portbench import trace

PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
SPLITS_W, SPLITS_L, SPLIT_ROWS_MIN = 8, 32, 16


def splits(R, nl):
    return (max(1, min(SPLITS_W, R // SPLIT_ROWS_MIN)),
            max(1, min(SPLITS_L, nl * R // SPLIT_ROWS_MIN)))


def bound_s(K, B, N, nl, reason=True, H=100):
    r = int(reason)
    R = B * N
    flops = nl * (6 * B * N * N * H + (12 + 48 * r) * R * H * H
                  + 40 * R * H)
    sw, sl = splits(R, nl)
    scratch = (r * nl * R * 4 * H + 2 * nl * R * H + r * nl * R * 4 * H
               + nl * sw * 2 * H * H + r * sl * (2 * H + 1) * 4 * H)
    nbytes = 4 * (2 * B * N * N + 4 * R * H + 2 * nl * 2 * H * H
                  + r * 2 * (8 * H * H + 4 * H) + (2 + 2 * r) * nl * R * H
                  + 2 * scratch)
    return K * max(flops / PEAK_FP32, nbytes / PEAK_BYTES)


def read(ctx):
    t = ctx.get("trace")
    if not t:
        return None
    spent = trace.seconds_of(t, "gcnii_bwd")
    if spent <= 0:
        return None
    nl = ctx["cfg"]["model"]["Deep_GCN_nlayers"]
    reason = ctx["cfg"]["model"]["reason_flag"]
    least = sum(bound_s(ctx["K"], u[1], 3 * u[2], nl, reason)
                for u in ctx["prof_units"] if u[0] == "step")
    return 100.0 * least / spent
