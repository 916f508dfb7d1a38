from vct_tpu_torch.clip.vision import CLIPVisionTower, preprocess_frames  # noqa: F401
from vct_tpu_torch.clip.frames import sample_frames, parse_ext_type  # noqa: F401
from vct_tpu_torch.clip.text import (  # noqa: F401
    CLIPBPETokenizer,
    CLIPTextTower,
    build_text_encoder,
)
