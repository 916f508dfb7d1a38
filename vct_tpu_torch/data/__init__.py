from vct_tpu_torch.data.datasets import MSRVTTDataset, MSVDDataset, VATEXDataset, build_dataset  # noqa: F401
from vct_tpu_torch.data.loader import DataLoader  # noqa: F401
