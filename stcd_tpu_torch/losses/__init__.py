"""Losses of the port (counterpart of stcd_tpu/losses): the reference's
``functional`` losses and smp's loss family (``smp``)."""

from stcd_tpu_torch.losses.functional import (bce_dice, bce_loss, cd_loss,  # noqa: F401
                                              contrastive_loss, cross_entropy, dice_loss,
                                              focal_loss, miou_loss, mmiou_loss)
from stcd_tpu_torch.losses.smp import (BINARY_MODE, MULTICLASS_MODE,  # noqa: F401
                                       MULTILABEL_MODE, DiceLoss, FocalLoss, JaccardLoss,
                                       LovaszLoss, MCCLoss, SoftBCEWithLogitsLoss,
                                       SoftCrossEntropyLoss, TverskyLoss)
