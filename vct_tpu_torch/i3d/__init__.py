from vct_tpu_torch.i3d.model import (  # noqa: F401
    FEATURE_DIM,
    I3DTower,
    i3d_stacks,
    preprocess_i3d_frames,
    resize_center_crop,
    scale_i3d_frames,
)
from vct_tpu_torch.i3d.convert import convert_i3d, load_i3d_state_dict  # noqa: F401
from vct_tpu_torch.i3d.flow import (  # noqa: F401
    estimate_flow,
    flow_from_cropped,
    preprocess_i3d_flow,
)
