"""Training substrate: optimizer, data pipeline, fault-tolerant loop."""
from repro_torch.train.optimizer import AdamWConfig, adamw_update, init_opt_state
from repro_torch.train.train_state import TrainState, init_train_state, make_train_step
