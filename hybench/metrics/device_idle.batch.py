"""``device_idle.batch``: see ``hybench.readers.device_idle``."""

from hybench.readers import device_idle


def read(ctx):
    return device_idle(ctx)
