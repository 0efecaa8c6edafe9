"""Device ms a batch in every device operation but the traversal kernels:
shading, sorts, raygen, resolve, the loop's torch operations and copies."""


def read(ctx):
    t, n = ctx["trace"], ctx["traced"]["batches"]
    if not t or not n or t["other_s"] <= 0:
        return None
    return t["other_s"] * 1e3 / n
