"""repro_torch.checkpoint — the port's numpy checkpointer, in the
reference's format (``repro.checkpoint``): checkpoints cross between the
two packages."""
from repro_torch.checkpoint.store import (latest_published_step, latest_step,
                                          map_leaves, publish, read_host,
                                          restore, save, saved_steps)

__all__ = ["save", "restore", "read_host", "latest_step", "saved_steps",
           "latest_published_step", "publish", "map_leaves"]
