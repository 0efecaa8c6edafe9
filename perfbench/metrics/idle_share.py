"""Share (%) of the time in which no operation ran on the device, with
the profiler's own cost left out: 1 - (device seconds a unit in the traced
stretch: the union of the device operations' intervals) / (wall seconds a
unit in the untraced stretch just before it). The profiler slows the host
path, not the device's operations, so the traced stretch's own idle share
(``device.busy_s`` over ``device.window_s``) reads higher."""


def read(ctx):
    t, n = ctx["trace"], ctx["traced"]
    if not t or not n["units"] or not n["plain_unit_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / n["units"] / n["plain_unit_s"])
