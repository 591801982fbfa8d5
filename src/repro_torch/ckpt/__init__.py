from repro_torch.ckpt.checkpoint import (CheckpointManager, latest_step,
                                         restore, save)

__all__ = ["CheckpointManager", "restore", "save", "latest_step"]
