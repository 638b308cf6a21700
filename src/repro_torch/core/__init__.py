"""INT8 post-training quantization and INT4 weights (port of ``repro/core``)."""

from repro_torch.core.calibration import (  # noqa: F401
    Calibrator,
    SiteCalibration,
    Taps,
    kl_threshold_search,
    kl_thresholds,
    record,
)
from repro_torch.core.histogram import StreamingHistogram, classify  # noqa: F401
from repro_torch.core.policy import QuantPolicy, summarize  # noqa: F401
from repro_torch.core.ptq import (  # noqa: F401
    FP_CONTEXT,
    QuantContext,
    count_quantized,
    generic_site,
    int4_eligible_site,
    quantize_model,
    quantize_weight,
    quantize_weight_block,
    weight_bytes_by_site,
)
from repro_torch.core.qtensor import (  # noqa: F401
    BlockQTensor,
    QTensor,
    abs_max,
    quantize_affine,
    quantize_block,
    quantize_symmetric,
)
from repro_torch.core.quantize import (  # noqa: F401
    QuantMode,
    Thresholds,
    fake_quant,
    fake_quant_dynamic,
    quantize_dynamic,
    quantize_naive,
    quantize_with_thresholds,
)
