"""Wall milliseconds a request inside the quadrangle search
(``find_quadrangle_batch``), synchronised at both ends, in the traced run's
second slice."""


def read(ctx):
    times = ctx.synced_ms.get("quad")
    if not times or not ctx.synced_requests:
        return None
    return sum(times) / ctx.synced_requests
