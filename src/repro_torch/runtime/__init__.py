"""Runtime harness of the port: the straggler monitor the serving engine
times its ticks with (``runtime.fault``)."""

from .fault import StragglerMonitor  # noqa: F401
