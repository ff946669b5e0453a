"""Training: the AdamW optimizer, the LM trainer and checkpoints."""
from .optim import AdamWConfig, adamw_update, init_opt_state, lr_at, global_norm
