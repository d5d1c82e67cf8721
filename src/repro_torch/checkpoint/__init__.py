from repro_torch.checkpoint.io import (
    load_metadata, restore_checkpoint, save_checkpoint)

__all__ = ["load_metadata", "restore_checkpoint", "save_checkpoint"]
