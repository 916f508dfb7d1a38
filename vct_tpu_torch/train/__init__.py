from vct_tpu_torch.train.earlystop import EarlyStopping  # noqa: F401
from vct_tpu_torch.train.optimizers import build_optimizer, CosineAnnealingLR, ReduceLROnPlateau  # noqa: F401
from vct_tpu_torch.train.state import TrainState  # noqa: F401
