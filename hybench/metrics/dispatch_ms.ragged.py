"""``dispatch_ms.ragged``: see ``hybench.readers.dispatch_ms``."""

from hybench.readers import dispatch_ms


def read(ctx):
    return dispatch_ms(ctx)
