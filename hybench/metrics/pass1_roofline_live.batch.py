"""``pass1_roofline_live.batch``: see ``hybench.span_readers.pass1_roofline_live``."""

from hybench.span_readers import pass1_roofline_live


def read(ctx):
    return pass1_roofline_live(ctx)
