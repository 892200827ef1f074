"""Host-side utilities of the port.

  meters   AverageMeter (the accuracy tables) and Throughput (the train loop)
  tables   print_mean_accuracy, the CIL result table
  logging  get_logger and the JSONL MetricLogger
  profiling  trace (a torch.profiler chrome trace), annotate (the program's spans), spans
"""

from .logging import MetricLogger, get_logger
from .meters import AverageMeter, Throughput
from .tables import print_mean_accuracy

__all__ = ["AverageMeter", "MetricLogger", "Throughput", "get_logger", "print_mean_accuracy"]
