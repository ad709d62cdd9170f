from repro_torch.train.optim import Optimizer, adafactor, adamw, get_optimizer
from repro_torch.train.step import (clip_by_global_norm, global_norm,
                                    make_sharded_train_step, make_train_step)
