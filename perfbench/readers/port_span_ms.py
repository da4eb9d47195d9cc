"""Host wall ms a step inside the port's own spans over the measured
window (``boofcv_tpu_torch.utils.profiling``'s recorder, on by default).

The window's steps are found by their root spans: the records named in
``roots`` with no parent, one a step, in order.  The warm-up replay runs
before the window and the profiled replay after it, so the window's steps
are the ``ctx.steps`` roots that come before the last
``ctx.profiled_steps``.  Over the records of those steps whose name is in
``spans``, the duration (with ``self``, less that of its direct children)
is summed and divided by the window's steps.  No synchronize: the host's
time to launch the work, or its wait at a sync.

Nothing to read gives nothing: a port without the recorder, fewer roots
than the window and the profiled replay have, records of the window
pushed out of the ring, or a root longer than its step's latency (the
roots would not be the window's steps)."""


def read(ctx, spans, roots, self=False):
    try:
        from boofcv_tpu_torch.utils import profiling
        records, dropped = profiling.records, profiling.dropped
    except (ImportError, AttributeError):
        return None
    recs = records()
    found = [r for r in recs if r[0] in roots and r[2] is None]
    need = ctx.steps + ctx.profiled_steps
    if not ctx.steps or len(found) < need \
            or len(ctx.latencies_s) != ctx.steps:
        return None
    window = found[len(found) - need:len(found) - ctx.profiled_steps]
    # a dropped record closed before the oldest kept one did
    if dropped() and recs[0][5] > window[0][4]:
        return None
    if any(r[5] - r[4] > 1e9 * lat for r, lat in zip(window,
                                                      ctx.latencies_s)):
        return None
    steps = {r[1] for r in window}
    mine = [r for r in recs if r[3] in steps]
    children = {}
    for r in mine:
        if r[2] is not None:
            children[r[2]] = children.get(r[2], 0) + r[5] - r[4]
    total = sum(r[5] - r[4] - (children.get(r[1], 0) if self else 0)
                for r in mine if r[0] in spans)
    return total / 1e6 / ctx.steps
