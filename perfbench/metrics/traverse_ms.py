"""Device ms a batch in the tile intersector's kernels (K1 and K2, and
any other hand-written traversal kernel), by kernel name in the trace."""


def read(ctx):
    t, n = ctx["trace"], ctx["traced"]["batches"]
    if not t or not n or t["traversal_s"] <= 0:
        return None
    return t["traversal_s"] * 1e3 / n
