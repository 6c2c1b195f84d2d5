from repro_torch.checkpoint.ckpt import (CheckpointCorruptError,  # noqa: F401
                                         CheckpointStore, load_checkpoint,
                                         save_checkpoint)
