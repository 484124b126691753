"""Classification metrics of the port (numpy on the host)."""

from tennis_torch.metrics.accuracy import Accuracy, TopKAccuracy
from tennis_torch.metrics.vision import PRF1, confusion_matrix, \
    prf1_from_confusion

__all__ = ["Accuracy", "TopKAccuracy", "PRF1", "confusion_matrix",
           "prf1_from_confusion"]
