"""``search_mfu.ragged``: see ``hybench.readers.search_mfu``."""

from hybench.readers import search_mfu


def read(ctx):
    return search_mfu(ctx)
