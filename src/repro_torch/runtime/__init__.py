"""Runtime harness of the port: the straggler monitor, elastic plan and
resilient loop (``runtime.fault``), gradient compression
(``runtime.compression``), and the op-level cost accounting of a step's
call (``runtime.op_cost``)."""

from .fault import ElasticMeshPlan, StragglerMonitor, run_resilient  # noqa: F401
