from mmdfn_torch.losses.losses import (focal_loss, masked_mse_loss,
                                      masked_nll_loss)

__all__ = ["focal_loss", "masked_mse_loss", "masked_nll_loss"]
