"""Host wall ms a step inside a span over the measured window: every
outermost call of ``span``, less the time inside the spans of ``minus``
nested in it, summed and divided by the window's steps.  No synchronize:
this is the host's time to issue the work."""


def read(ctx, span: str, minus=()):
    if span in ctx.missing or any(m in ctx.missing for m in minus):
        return None
    own = [(a, b) for s, a, b in ctx.records if s == span]
    if not own or not ctx.steps:
        return None
    inner = sorted((a, b) for s, a, b in ctx.records if s in minus)
    total = sum(b - a for a, b in own)
    for a, b in inner:
        if any(x <= a and b <= y for x, y in own):
            total -= b - a
    return 1000.0 * total / ctx.steps
