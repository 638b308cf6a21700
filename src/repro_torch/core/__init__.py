"""INT8 post-training quantization (port of ``repro/core``)."""

from repro_torch.core.calibration import (  # noqa: F401
    Calibrator,
    SiteCalibration,
    Taps,
    kl_threshold_search,
    kl_thresholds,
    record,
)
from repro_torch.core.histogram import StreamingHistogram, classify  # noqa: F401
from repro_torch.core.policy import QuantPolicy  # noqa: F401
from repro_torch.core.ptq import (  # noqa: F401
    FP_CONTEXT,
    QuantContext,
    generic_site,
    quantize_model,
    quantize_weight,
)
from repro_torch.core.qtensor import (  # noqa: F401
    QTensor,
    abs_max,
    quantize_affine,
    quantize_symmetric,
)
from repro_torch.core.quantize import (  # noqa: F401
    QuantMode,
    Thresholds,
    quantize_with_thresholds,
)
