"""Seconds of one phase of set-up, ``setup_span.<phase>`` (host clock, the
device synchronized at its end): ``build``, ``scene`` or ``graphs``, as
perfbench.cell.run names them."""


def read(ctx):
    return ctx["spans"].get(ctx["metric"].split(".", 1)[1])
