from repro_torch.train.optimizer import adamw_init, adamw_update, OptimizerConfig
from repro_torch.train.schedule import lr_schedule
from repro_torch.train.train_step import make_train_step, TrainState
