"""Seconds from the process's start to the window's: imports, inputs and
weights from the seed, the program built, warmed up and captured."""


def read(ctx):
    return ctx.get('setup_s')
