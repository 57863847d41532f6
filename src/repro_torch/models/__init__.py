"""Model code of the port: configs, layers, attention, decode."""

from .config import ModelConfig, param_count  # noqa: F401
from .transformer import init_params  # noqa: F401
from .decode import (decode_chunk, decode_step, init_cache,  # noqa: F401
                     merge_slots, reset_slots)
