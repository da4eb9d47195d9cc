"""A quantile of the window's frame latencies, in ms: the host wall time
from handing a frame (a batched step: every stream's frame) to the port
to holding its pose on the host.  Inclusive quantiles (linear between the
ranks), over every step of the window."""

import statistics


def read(ctx, q: float = 0.95):
    lat = ctx.latencies_s
    if len(lat) < 2:
        return None
    cut = statistics.quantiles(lat, n=1000, method="inclusive")
    return 1000.0 * cut[int(round(q * 1000)) - 1]
