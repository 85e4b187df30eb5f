"""Host utilities of the port: the binary game logs."""

from .gamelog import GameLogWriter, read_log, write_trajectory_log

__all__ = ["GameLogWriter", "read_log", "write_trajectory_log"]
