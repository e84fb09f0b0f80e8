from . import optimizer, train_step
from .optimizer import AdamWConfig
from .train_step import init_train_state, loss_fn, make_train_step
