"""Host utilities of the port: the binary game logs, checkpoints,
profiling and visualization (matplotlib imported only where it draws)."""

from .checkpoint import checkpointed_scan, load_checkpoint, save_checkpoint
from .gamelog import GameLogWriter, read_log, write_trajectory_log
from .profiling import PhaseTimer, counters_line, trace

__all__ = ["GameLogWriter", "read_log", "write_trajectory_log",
           "save_checkpoint", "load_checkpoint", "checkpointed_scan",
           "PhaseTimer", "counters_line", "trace"]
