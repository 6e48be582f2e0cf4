from .store import (AsyncCheckpointer, ShardedCheckpointer, latest_step, restore_checkpoint,
                    save_checkpoint)
