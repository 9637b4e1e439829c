from .adamw import AdamWState, adamw_init, adamw_update, global_norm  # noqa: F401
from .schedule import warmup_cosine  # noqa: F401
from .compress import (  # noqa: F401
    CompressState, compress_init, compress_grads,
)
