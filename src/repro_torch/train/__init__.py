from repro_torch.train.loop import (Trainer, cache_specs,
                                    make_guarded_train_step, make_prefill_fn,
                                    make_serve_step, make_train_step)

__all__ = ["Trainer", "cache_specs", "make_guarded_train_step",
           "make_prefill_fn", "make_serve_step", "make_train_step"]
