"""Entry points of the port: fixed-shape serving steps, the serve CLI and
the trace report CLI."""
