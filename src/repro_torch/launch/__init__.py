"""Entry points of the port: fixed-shape serving steps and the serve CLI."""
