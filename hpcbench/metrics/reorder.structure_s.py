"""reorder.structure_s (s): the host clock around
``reorder.auto_structure`` in the set-up (the harness's span)."""


def read(ctx):
    return ctx.spans.get("reorder.structure")
