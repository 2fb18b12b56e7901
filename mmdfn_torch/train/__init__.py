from mmdfn_torch.train.trainer import EpochMetrics, FitResult, Trainer

__all__ = ["DailyTrainer", "EpochMetrics", "FitResult", "Trainer"]


def __getattr__(name):
    # DailyDialogue's trainer on first use: the other paths never need it
    if name == "DailyTrainer":
        from mmdfn_torch.train.daily_trainer import DailyTrainer
        return DailyTrainer
    raise AttributeError(name)
