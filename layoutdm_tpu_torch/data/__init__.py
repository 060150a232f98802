from layoutdm_tpu_torch.data.datasets import LayoutData, load_dataset  # noqa: F401
from layoutdm_tpu_torch.data.loader import batch_iterator  # noqa: F401
