from mmdfn_torch.train.trainer import EpochMetrics, FitResult, Trainer

__all__ = ["EpochMetrics", "FitResult", "Trainer"]
