from . import pipeline
from .pipeline import DataConfig, batch_for_step
