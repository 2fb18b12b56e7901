"""``device.idle_pct``: the share of the traced sub-window's stream time in
which no operation ran on the device, in %: 100 (1 - busy / window), busy
the union of the device operations' intervals from torch.profiler."""


def read(ctx):
    t = ctx.get("trace")
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
