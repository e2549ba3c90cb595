from uvol_tpu_torch.codecs.corto.decoder import CortoMesh, decode_crt  # noqa: F401
from uvol_tpu_torch.codecs.corto.encoder import (  # noqa: F401
    CrtCustomAttr,
    encode_crt,
)
