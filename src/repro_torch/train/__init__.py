"""Training on the port: AdamW, the train step and the checkpointing loop."""
from .loop import LoopConfig, Trainer
from .optimizer import AdamWConfig, AdamWState, adamw_update, init_adamw, lr_schedule
from .trainstep import LossConfig, TrainState, init_train_state, make_loss_fn, make_train_step
