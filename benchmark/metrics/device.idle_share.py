"""device.idle_share: 100 x (1 - the union of the device intervals over the
traced wall time) of the traced cycle (one stream: the H100)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
