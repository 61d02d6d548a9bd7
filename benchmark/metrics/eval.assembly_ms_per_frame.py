"""The evaluator's own 'assembly' mark (KITTI reads, merge, resize,
encode on its producer threads) per frame, over the window's passes."""


def read(ctx):
    stages = ctx.get('stage_ms')
    return None if not stages else stages.get('assembly')
