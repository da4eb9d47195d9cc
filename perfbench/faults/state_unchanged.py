"""Fault for the harness's own tests: the VO step returns the state it
was given (its metrics are the real step's).  Listed under ``faults`` in a
test cell's settings, and read on the card by ``control.py --fault
state_unchanged``; never in a benchmark cell."""


def apply(port):
    sv = port.stereo_vo
    orig = (sv.make_step, sv.make_batched_step)

    def broken(make):
        def make_broken(*a, **k):
            step = make(*a, **k)

            def step_broken(state, left, right):
                _, metrics = step(state, left, right)
                return state, metrics
            return step_broken
        return make_broken

    sv.make_step, sv.make_batched_step = broken(orig[0]), broken(orig[1])

    def undo():
        sv.make_step, sv.make_batched_step = orig
    return undo
