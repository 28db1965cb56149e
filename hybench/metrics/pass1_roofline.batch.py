"""``pass1_roofline.batch``: see ``hybench.readers.pass1_roofline``."""

from hybench.readers import pass1_roofline


def read(ctx):
    return pass1_roofline(ctx)
