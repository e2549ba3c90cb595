from uvol_tpu_torch.ops.morton import morton30, morton63, morton_order  # noqa: F401
from uvol_tpu_torch.ops.normals import (  # noqa: F401
    estimate_normals,
    octahedral_decode,
    octahedral_encode,
)
from uvol_tpu_torch.ops.prediction import (  # noqa: F401
    delta_decode,
    delta_encode,
    parallelogram_decode,
    parallelogram_encode,
)
from uvol_tpu_torch.ops.quantize import (  # noqa: F401
    QuantizedAttr,
    compute_quantization_transform,
    corto_quantization_step,
    dequantize,
    dequantize_step,
    quantize,
    quantize_step,
    zigzag_decode,
    zigzag_encode,
)
