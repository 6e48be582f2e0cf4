from .store import AsyncCheckpointer, latest_step, restore_checkpoint, save_checkpoint
