"""``host_ms.batch``: see ``hybench.span_readers.host_ms``."""

from hybench.span_readers import host_ms


def read(ctx):
    return host_ms(ctx)
