"""Samples of every train step completed in the window over the window's
wall time, by the host clock (the window ends when the card is done)."""


def read(ctx):
    if ctx.get('kind') != 'train' or not ctx.get('window_s'):
        return None
    return ctx['units'] / ctx['window_s']
