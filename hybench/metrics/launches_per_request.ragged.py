"""``launches_per_request.ragged``: see ``hybench.readers.launches_per_request``."""

from hybench.readers import launches_per_request


def read(ctx):
    return launches_per_request(ctx)
