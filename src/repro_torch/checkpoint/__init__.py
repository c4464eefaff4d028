from .sharded import (AsyncCheckpointer, latest_step, list_steps,
                      restore_checkpoint, save_checkpoint)

__all__ = ["AsyncCheckpointer", "latest_step", "list_steps",
           "restore_checkpoint", "save_checkpoint"]
