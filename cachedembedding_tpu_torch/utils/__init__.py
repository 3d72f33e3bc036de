from cachedembedding_tpu_torch.utils.metrics import StreamingMetrics, accuracy, auroc  # noqa: F401
from cachedembedding_tpu_torch.utils.misc import get_mem_info  # noqa: F401
from cachedembedding_tpu_torch.utils.timer import Timer, get_time_elapsed  # noqa: F401
