"""Frames whose predictions were written in the window over the window's
wall time, by the host clock (whole passes over the split)."""


def read(ctx):
    if ctx.get('kind') != 'eval' or not ctx.get('window_s'):
        return None
    return ctx['units'] / ctx['window_s']
