"""AdamW with optional INT8 moments, and the paper's cosine schedule."""

from .adamw import AdamWState, adamw_init, adamw_update  # noqa: F401
from .schedule import cosine_with_warmup  # noqa: F401
