"""Layer: Device.  The share of the traced window in which no kernel, copy
or memset ran on the card (the union of their intervals), in percent."""


def read(ctx):
    tr = ctx.trace
    if tr.window_s <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
