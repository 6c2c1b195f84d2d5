from repro_torch.train.loop import Trainer, make_train_step

__all__ = ["Trainer", "make_train_step"]
