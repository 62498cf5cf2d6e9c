from . import kernel, megakernel, ops
from .kernel import mr_schedule, mr_schedule_plain
from .megakernel import initial_state, mr_epoch, mr_epoch_plain
from .ops import (epoch_schedule, epoch_schedule_compact, epoch_trace,
                  schedule)

__all__ = ["kernel", "megakernel", "ops", "initial_state", "mr_epoch",
           "mr_epoch_plain", "mr_schedule", "mr_schedule_plain",
           "epoch_schedule", "epoch_schedule_compact", "epoch_trace",
           "schedule"]
