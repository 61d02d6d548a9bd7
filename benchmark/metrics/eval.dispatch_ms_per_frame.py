"""The evaluator's own 'dispatch' mark (the span 'eval.dispatch': a group
stacked, uploaded, its step launched and its copies to the host started,
without the wait for room in the pull pipeline's queue) per frame, over
the window's passes."""


def read(ctx):
    stages = ctx.get('stage_ms')
    return None if not stages else stages.get('dispatch')
