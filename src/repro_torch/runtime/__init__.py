"""Runtime harness of the port: the straggler monitor the serving engine
times its ticks with (``runtime.fault``), and the op-level cost
accounting of a step's call (``runtime.op_cost``)."""

from .fault import StragglerMonitor  # noqa: F401
