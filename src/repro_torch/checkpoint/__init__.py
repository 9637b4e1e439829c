from .checkpointer import (  # noqa: F401
    Checkpointer, latest_step, read_manifest, save_checkpoint,
    restore_checkpoint,
)
