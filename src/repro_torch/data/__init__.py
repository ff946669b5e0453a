"""Synthetic instruction suite: tokenizer and task generator (copies of
``repro.data``)."""
from . import tokenizer
from .tasks import (TASKS, TaskSpec, QueryDataset, generate_dataset,
                    lm_training_arrays)
