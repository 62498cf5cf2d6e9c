from . import megakernel, ops
from .megakernel import initial_state, mr_epoch, mr_epoch_plain
from .ops import epoch_schedule

__all__ = ["megakernel", "ops", "initial_state", "mr_epoch",
           "mr_epoch_plain", "epoch_schedule"]
