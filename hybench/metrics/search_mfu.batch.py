"""``search_mfu.batch``: see ``hybench.readers.search_mfu``."""

from hybench.readers import search_mfu


def read(ctx):
    return search_mfu(ctx)
