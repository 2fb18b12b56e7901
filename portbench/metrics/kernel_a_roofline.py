"""``kernel_a_roofline``: kernel A's (one bi-GRU layer's recurrence
forward, ``csrc/bigru_fwd.cu``) share of its roofline in the traced
sub-window, in %: the sum over its launches of each launch's least time,
over the device time of its kernels there (labels ``bigru_fwd...``).
Each launch is an ``ops.bigru_fwd`` span of the program
(``mmdfn_torch/ops/bigru.py``) whose attributes give the shape as
launched: K configurations of B rows of L steps, H, G = 3H, ``train``
(training mode writes hg) and ``mode``.  Nothing where the program logs
no such span or the sub-window gives kernel A no time.

A launch's least time is the larger of its f32 operations at 67 TFLOP/s
and its bytes at 3.35 TB/s (an H100 SXM's published peaks at 700 W);
the bf16 scan mode's product runs at the bf16 rate, 989 TFLOP/s.  The
counts (``chip_smoke.py``'s, times K), per configuration and both
directions: per step and row ``h @ W_hh`` (2 H G) and about 12 H of gate
math; bytes: xg in, W_hh and b_hh, the mask, ys out (f32), and in
training mode hg out (f32).  The bf16 scan mode reads and writes bf16
(the mask f32) with about 30 H of gate math a row and step."""

from portbench import program, trace

PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12


def bound_s(K, B, L, H=100, G=300, train=False, mode="f32"):
    rows = 2 * B * L
    hg = 4 * rows * G if train else 0
    if mode == "bf16_scan":
        nbytes = 2 * (rows * G + 2 * (H * G + G) + rows * H) + 4 * B * L + hg
        ops_s = rows * 30 * H / PEAK_FP32 + rows * 2 * H * G / PEAK_BF16
    else:
        nbytes = 4 * (2 * B * L * G + 2 * (H * G + G) + B * L
                      + 2 * B * L * H) + hg
        ops_s = 2 * L * B * (2 * H * G + 12 * H) / PEAK_FP32
    return K * max(ops_s, nbytes / PEAK_BYTES)


def read(ctx):
    t = ctx.get("trace")
    if not t:
        return None
    spent = sum(s for n, s in t["by_label"].items()
                if n.startswith(trace.KERNEL_A_PARTS))
    least = sum(bound_s(**s.attrs) for s in program.spans("ops.bigru_fwd"))
    if spent <= 0 or least <= 0:
        return None
    return 100.0 * least / spent
