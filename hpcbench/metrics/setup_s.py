"""setup_s (s): the program's set-up (see ``hpcbench.run.set_up``)."""


def read(ctx):
    return ctx.setup_s if ctx.setup_s > 0 else None
