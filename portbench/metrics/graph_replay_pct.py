"""Layer: Step dispatch (host).  The share of the window's calls whose
``nbls.step`` span holds a ``nbls.graph.replay`` span: steps replayed from
CUDA graphs rather than enqueued operation by operation from Python (calls
wholly inside the traced window, ``harness/spans.py``), in percent.
Nothing to read where the trace holds no ``nbls.graph.replay`` span."""

from portbench.harness import spans

REPLAY, STEP = "nbls.graph.replay", "nbls.step"


def read(ctx):
    sp = spans.of(ctx.trace)
    calls = sp.calls()
    replays = [s for s in sp.spans if s.name == REPLAY]
    if not calls or not replays:
        return None
    ids = {id(c) for c in calls}
    replayed = set()
    for s in replays:
        step = s.parent
        while step is not None and step.name != STEP:
            step = step.parent
        if step is not None and id(step.call) in ids:
            replayed.add(id(step.call))
    return 100.0 * len(replayed) / len(calls)
