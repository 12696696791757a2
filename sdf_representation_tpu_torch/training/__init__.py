from .pcd_trainer import PointCloudTrainer
from .trainer import Trainer

__all__ = ["PointCloudTrainer", "Trainer"]
