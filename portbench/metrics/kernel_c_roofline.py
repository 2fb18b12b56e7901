"""``kernel_c_roofline``: kernel C's (one bi-GRU layer's recurrence
backward, ``csrc/bigru_bwd.cu``) share of its roofline in the traced
sub-window, in %: the sum over its launches of each launch's least time,
over the device time of its kernels there (the walk, labels
``bigru_bwd...``, and the weight-gradient kernels after it,
``bigru_wgrad...``).  Each launch is an ``ops.bigru_bwd`` span of the
program (``mmdfn_torch/ops/bigru.py``) whose attributes give the shape as
launched: K configurations of B rows of L steps, H, G = 3H and ``mode``.
Nothing where the program logs no such span or the sub-window gives
kernel C no time.

A launch's least time is the larger of its f32 operations at 67 TFLOP/s
and its bytes at 3.35 TB/s (an H100 SXM's published peaks at 700 W);
the bf16 scan mode's products run at the bf16 rate, 989 TFLOP/s.  The
counts (``chip_smoke.py``'s, times K), per configuration and both
directions: per step and row ``dhg @ W_hh^T`` (2 H G) and about 30 H of
gate math, and after the loop ``[h_prev, 1]^T dhg`` (2 (H + 1) G); bytes:
xg, hg, ys, dy, the mask and W_hh in, dxg, dW_hh and db_hh out (f32; the
scratch the kernel writes and reads back is not counted).  The bf16 scan
mode reads and writes bf16 (the mask f32) with about 60 H of gate math a
row and step."""

from portbench import program, trace

PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12


def bound_s(K, B, L, H=100, G=300, mode="f32"):
    rows = 2 * B * L
    if mode == "bf16_scan":
        nbytes = (2 * (2 * rows * G + 2 * rows * H + 2 * (H * G + G))
                  + 4 * B * L + 2 * (rows * G + 2 * (H * G + G)))
        ops_s = (rows * 60 * H / PEAK_FP32
                 + rows * 2 * (2 * H + 1) * G / PEAK_BF16)
    else:
        nbytes = 4 * (2 * (2 * B * L * G + 2 * B * L * H + H * G) + B * L
                      + 2 * B * L * G + 2 * (H * G + G))
        ops_s = (2 * L * B * (2 * H * G + 2 * (H + 1) * G + 30 * H)
                 / PEAK_FP32)
    return K * max(ops_s, nbytes / PEAK_BYTES)


def read(ctx):
    t = ctx.get("trace")
    if not t:
        return None
    spent = sum(s for n, s in t["by_label"].items()
                if n.startswith(trace.KERNEL_C_PARTS + ("bigru_wgrad",)))
    least = sum(bound_s(**s.attrs) for s in program.spans("ops.bigru_bwd"))
    if spent <= 0 or least <= 0:
        return None
    return 100.0 * least / spent
