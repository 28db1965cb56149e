"""``pass23_device_ms.batch``: see ``hybench.span_readers.pass23_device_ms``."""

from hybench.span_readers import pass23_device_ms


def read(ctx):
    return pass23_device_ms(ctx)
