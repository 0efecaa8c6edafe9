"""Host seconds of one phase of the program's last accel build,
``accel_s.<phase>``: ``order`` (the world triangles' Morton sort and the
cluster order), ``pack`` or ``shade_rows``, read from the build record
the program keeps (``tpurt_torch.render.accel_build_record``). None where
the program keeps no such record or no such phase."""


def read(ctx):
    from tpurt_torch import render

    record = getattr(render, "accel_build_record", None)
    if record is None:
        return None
    seconds = record().get("seconds", {})
    return seconds.get(ctx["metric"].split(".", 1)[1])
