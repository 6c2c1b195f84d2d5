from repro_torch.train.loop import (Trainer, make_guarded_train_step,
                                    make_train_step)

__all__ = ["Trainer", "make_guarded_train_step", "make_train_step"]
