from .chunked import save_checkpoint, restore_checkpoint, latest_step, Manifest
