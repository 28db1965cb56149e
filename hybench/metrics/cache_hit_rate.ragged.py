"""``cache_hit_rate.ragged``: see ``hybench.readers.cache_hit_rate``."""

from hybench.readers import cache_hit_rate


def read(ctx):
    return cache_hit_rate(ctx)
