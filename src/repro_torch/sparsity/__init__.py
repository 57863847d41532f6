"""The DB-PIM sparsity layer of the port: compression artifacts and the
cost model's view of them, kernel tables, stacked serving tables and the
in-step INT8 serving format (``sparse_linear``)."""

from .sparse_linear import (ELIGIBLE, DBPIMCompressed,  # noqa: F401
                            dequant_params_for_serving, dequant_tree,
                            pim_speedup_estimate,
                            quantize_params_for_serving, sparsify_params)
