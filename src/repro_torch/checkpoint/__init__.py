from .manager import (CheckpointManager, complete_steps, conform,  # noqa: F401
                      is_complete, load_pytree, read_meta, save_pytree,
                      step_path, to_host)
