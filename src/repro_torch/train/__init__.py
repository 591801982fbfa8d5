from repro_torch.train.step import (TrainConfig, compute_grads,
                                    init_state, init_train_state,
                                    make_compressed_train_fn,
                                    make_compressed_train_step,
                                    make_train_fn, make_train_step)

__all__ = ["TrainConfig", "init_train_state", "init_state",
           "compute_grads", "make_train_step", "make_train_fn",
           "make_compressed_train_step", "make_compressed_train_fn"]
