from esrganplus_tpu_torch.train.gan_model import GANTrainConfig, GANTrainer
from esrganplus_tpu_torch.train.schedule import multistep_lr
from esrganplus_tpu_torch.train.sftgan_model import SFTGANTrainConfig, SFTGANTrainer
from esrganplus_tpu_torch.train.sr_model import (SRTrainConfig, SRTrainer, make_optimizer,
                                                 pixel_loss)

__all__ = ["multistep_lr", "GANTrainConfig", "GANTrainer", "SFTGANTrainConfig",
           "SFTGANTrainer", "SRTrainConfig", "SRTrainer", "make_optimizer", "pixel_loss"]
