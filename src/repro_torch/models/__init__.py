"""Model code of the port: configs, layers, attention, decode."""

from .config import ModelConfig, param_count  # noqa: F401
from .transformer import init_params  # noqa: F401
from .decode import (decode_chunk, decode_chunk_, decode_step,  # noqa: F401
                     decode_step_, init_cache, merge_slots, reset_slots,
                     reset_slots_)
