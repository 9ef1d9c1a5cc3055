"""The share of the traced window in which no kernel, copy or memset ran
on the card: 1 - (union of their intervals) / window."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.window_s <= 0 or len(tr.dev_in) == 0:
        return None
    return 1.0 - tr.busy_s / tr.window_s
