"""The evaluator's own 'format' and 'write' marks (predictions formatted
and written) per frame, over the window's passes."""


def read(ctx):
    stages = ctx.get('stage_ms')
    if not stages:
        return None
    return stages.get('format', 0.0) + stages.get('write', 0.0)
