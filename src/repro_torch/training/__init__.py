"""Training (port of the JAX package's ``training/``): AdamW, the train
loop and checkpoints in the reference's format."""
from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.training.optimizer import (
    AdamW,
    AdamWState,
    apply_updates,
    cosine_warmup,
)
from repro_torch.training.train_loop import (
    TrainConfig,
    make_train_step,
    train,
    value_and_grad,
)

__all__ = ["AdamW", "AdamWState", "apply_updates", "cosine_warmup",
           "TrainConfig", "make_train_step", "train", "value_and_grad",
           "save_checkpoint", "load_checkpoint"]
