"""Online entry points of the port: the micro-batching query server."""
